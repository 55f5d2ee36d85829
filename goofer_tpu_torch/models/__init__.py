from goofer_tpu_torch.models.hnm import extract_features, synthesize

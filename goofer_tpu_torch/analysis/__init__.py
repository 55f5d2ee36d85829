from goofer_tpu_torch.analysis.pitch import track_pitch, fix_f0_gaps
from goofer_tpu_torch.analysis.formants import track_formants
from goofer_tpu_torch.analysis.features import extract_features

from goofer_tpu_torch.utils.audio_io import read_wav, write_wav

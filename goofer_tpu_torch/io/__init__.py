from goofer_tpu_torch.io.goofy import (
    save_features,
    load_features,
    formants_to_int_keys,
    pad_trim_to_len,
)

from goofer_tpu_torch.editor.core import (
    write_back_voicing,
    paint_mask_span,
    apply_f0_brush,
    fill_f0_for_painted_voicing,
)

from goofer_tpu_torch.parallel.mesh import make_mesh
from goofer_tpu_torch.parallel.batch import (
    NoteBatch,
    pad_note_batch,
    render_batch,
    render_batch_sharded,
    render_notes_sharded,
)

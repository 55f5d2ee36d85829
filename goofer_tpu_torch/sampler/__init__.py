from goofer_tpu_torch.sampler.flags import (
    parse_flags,
    NoteParams,
    note_to_midi,
    midi_to_hz,
)
from goofer_tpu_torch.sampler.pitchstring import pitch_string_to_cents

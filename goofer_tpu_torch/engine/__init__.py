from goofer_tpu_torch.engine.synth import (
    SynthStatic,
    default_knobs,
    synthesize,
)

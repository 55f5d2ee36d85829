"""The port's hand kernels for Hopper: one ctypes wrapper per
``csrc/*.cu`` source, each built at its first launch (``_build``), never
on import."""


def launch_counts() -> dict:
    """Launches of each kernel wrapper in this process, by name."""
    from goofer_tpu_torch.ops.cuda import (
        blur_kernel,
        burg_kernel,
        cascade_kernel,
        lpc_roots_kernel,
        pulse_kernel,
        viterbi_kernel,
    )

    return {w.__name__: w.launches for w in (
        pulse_kernel.pulse_accumulate, cascade_kernel.one_pole_cascade,
        blur_kernel.gaussian_blur, viterbi_kernel.pitch_viterbi,
        lpc_roots_kernel.lpc_roots, burg_kernel.burg_lpc)}

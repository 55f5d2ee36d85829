"""Multi-device dry run: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m goofer_tpu_torch.parallel.dryrun 4

Three steps on a ('dp', 'tp') mesh, with the same asserts as goofer_tpu's:
the batched render from knot envelopes with the decode reduced over tp
(``render_batch_sharded``, production frames 1024/256, n 8192, K 64,
b = 2 dp, tp 2 when the device count is even); the whole note render of
two note geometries planned through length buckets, sharded over the
mesh (``render_notes_sharded``), each note's padding silent; and the
sharded extraction of three tones (``extract_features_batch``).  Unlike
goofer_tpu's it never switches platforms: without ``devices`` it takes
the machine's cards and raises where there are fewer than asked.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from goofer_tpu_torch.engine.synth import SynthStatic
from goofer_tpu_torch.ops.envelope import _knot_bin_idx
from goofer_tpu_torch.parallel.batch import (
    render_batch_sharded,
    render_notes_sharded,
)
from goofer_tpu_torch.parallel.mesh import make_mesh


def _tiny_features(n, n_fft, hop, n_bins):
    t_frames = 1 + n // hop
    env = (np.exp(-np.linspace(0, 5, n_bins))[:, None]
           * np.ones((1, t_frames)) + 1e-5).astype(np.float32)
    f0 = np.full(n, 220.0, dtype=np.float32)
    f0[: n // 8] = 0.0
    mask = (f0 > 75).astype(np.float32)
    tracks = np.zeros((4, t_frames), dtype=np.float32)
    return env, f0, mask, tracks


def dryrun_multichip(n_devices: int, devices=None) -> None:
    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, tp=tp, devices=devices)
    dp = n_devices // tp

    sr, n_fft, hop = 44100, 1024, 256
    n = 8192
    n_bins = n_fft // 2 + 1
    k = 64
    b = 2 * dp
    env, f0, mask, tracks = _tiny_features(n, n_fft, hop, n_bins)
    bin_idx = _knot_bin_idx(sr, n_fft, k, n_bins)
    knots1 = np.log(np.maximum(env, 1e-8))[bin_idx, :]
    st = SynthStatic(sr=sr, n_fft=n_fft, hop=hop, n=n)
    mix, _, _, _ = render_batch_sharded(
        mesh, st, np.stack([knots1] * b), np.stack([f0] * b),
        np.stack([mask] * b), np.stack([tracks] * b))
    mix = mix.cpu()
    assert mix.shape == (b, n)
    assert bool(torch.isfinite(mix).all())

    _dryrun_full_render(mesh, n_devices)
    _dryrun_sharded_extraction(mesh)


def _dryrun_sharded_extraction(mesh) -> None:
    from goofer_tpu_torch.analysis.features import extract_features_batch

    sr = 44100
    rng = np.random.default_rng(0)
    t = np.arange(int(0.2 * sr)) / sr
    ys = [(0.4 * np.sin(2 * np.pi * f0 * t)
           + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
          for f0 in (180.0, 220.0, 260.0)]
    res = extract_features_batch(ys, sr, dense=False, mesh=mesh)
    assert len(res) == len(ys)
    for _env, f0i, vmask, _forms, knots in res:
        assert np.isfinite(f0i).all() and np.any(vmask > 0)
        assert np.isfinite(knots["knot_vals_log"].astype(np.float32)).all()


def _dryrun_full_render(mesh, n_devices: int) -> None:
    """Two note geometries planned through length buckets (masked, each
    note's n_true), each group's batch repeated to at least one note per
    slot and sharded over the mesh."""
    from goofer_tpu_torch.sampler.phrase import _Planned, group_planned
    from goofer_tpu_torch.sampler.resampler import (
        GooferResampler,
        _bucketize,
    )

    sr, n_fft, hop = 44100, 1024, 256
    ylen = 16384
    n_bins = n_fft // 2 + 1
    t = ylen // hop + 1
    env = (np.exp(-np.linspace(0, 5, n_bins))[:, None]
           * np.ones((1, t)) + 1e-5).astype(np.float32)
    f0i = np.full(ylen, 220.0)
    f0i[: ylen // 8] = 0.0
    vmask = (f0i > 75).astype(np.float64)
    forms = {i: np.full(t, 500.0 * i) for i in (1, 2, 3, 4)}

    prep_cache: dict = {}
    planned = []
    for i, (off, length) in enumerate([(0, 150), (10, 190)]):
        r = GooferResampler(
            "dry.wav", "/dev/null", "C4", 100, "t10B20", off, length, 40,
            0, 100, 0, "!120", "AA", n_fft=n_fft, hop=hop,
            device=mesh.slots[0], autorender=False)
        rs_i, arrays_i, scalars_i = r.prepare(
            env, f0i, vmask, forms, sr, ylen, cache=prep_cache)
        rs_i, arrays_i = _bucketize(rs_i, arrays_i, prep_cache)
        planned.append(_Planned(i, rs_i, arrays_i, scalars_i))

    for (rs, _sk), members in group_planned(planned).items():
        reps = max(1, -(-n_devices // len(members)))
        batch = (members * reps)[:max(n_devices, len(members))]
        out = render_notes_sharded(
            mesh, rs, [m.arrays for m in batch], [m.scalars for m in batch],
            [(0, j) for j in range(len(batch))]).cpu().numpy()
        assert out.shape == (len(batch), rs.n)
        assert bool(np.isfinite(out).all())
        assert float(np.abs(out).max()) > 0.0
        for m, row in zip(batch, out):
            n_true = int(m.scalars["n_true"])
            assert np.abs(row[:n_true]).max() > 0.0
            assert np.abs(row[n_true:]).max() == 0.0


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else
                     torch.cuda.device_count())
    print("ok")

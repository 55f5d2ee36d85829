"""The port's HTTP resampler server on the CPU (its kernels' plain
versions): the argument split, GET, a single POST against the CLI render,
a bad body, a burst merged into phrase renders, the SE1 direct path,
concurrent requests on a source without a cache, the logged fallback,
and the OpenUtau manifest against goofer_tpu's."""
import pytest

torch = pytest.importorskip("torch")

import logging  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from scipy.io import wavfile  # noqa: E402

import goofer_tpu.sampler.manifest as j_manifest  # noqa: E402
from goofer_tpu.sampler.server import (  # noqa: E402
    split_arguments as j_split_arguments,
)
from goofer_tpu_torch import cli  # noqa: E402
from goofer_tpu_torch.sampler import manifest, phrase, resampler, server  # noqa: E402

VOICE = Path(__file__).parent / "golden" / "voice"
TAIL = "100 {flags} 0 {length} 60 0 100 0 !120 AA"


@pytest.fixture(scope="module")
def url():
    """A live server on an ephemeral port, rendering on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")
    httpd = server.ThreadedHTTPServer(("127.0.0.1", 0), server.RequestHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    mp.undo()


@pytest.fixture
def src(tmp_path):
    shutil.copy(VOICE / "src.wav", tmp_path / "v.wav")
    shutil.copy(VOICE / "src_features.goofy", tmp_path / "v_features.goofy")
    return tmp_path / "v.wav"


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status


def _args(src, out, pitch="C4", flags="", length=300):
    return [str(src), str(out), pitch] + TAIL.format(
        flags=flags, length=length).split(" ")


def _pcm(path):
    return wavfile.read(path)[1]


@pytest.mark.parametrize("body", [
    "a.wav b.wav C4 100 g0 0 300 50 0 100 0 !120 AA",
    "/voice bank/a.wav /out dir/b.wav C4 100  0 300 50 0 100 0 !120 AA",
    "extra tokens x.wav in.wav out.wav D#4 90 t10B20 5 400 60 10 80 0 "
    "!140 AA#2#AB",
    "a.wav C4 100 g0 0 300 50 0 100 0 !120 AA",
    "garbage",
])
def test_split_arguments_matches_goofer_tpu(body):
    try:
        want = j_split_arguments(body)
    except ValueError:
        with pytest.raises(ValueError, match="Missing .wav"):
            server.split_arguments(body)
        return
    assert server.split_arguments(body) == want


def test_manifest_matches_goofer_tpu(tmp_path):
    assert manifest.manifest_dict() == j_manifest.manifest_dict()
    manifest.write_manifest(tmp_path / "ours.yaml")
    j_manifest.write_manifest(tmp_path / "theirs.yaml")
    assert ((tmp_path / "ours.yaml").read_bytes()
            == (tmp_path / "theirs.yaml").read_bytes())


def test_get_returns_200(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        assert resp.status == 200


def test_post_equals_cli_render(url, src, tmp_path):
    out = tmp_path / "post.wav"
    assert _post(url, " ".join(_args(src, out, flags="t15"))) == 200
    cli_out = tmp_path / "cli.wav"
    assert cli.main(_args(src, cli_out, flags="t15")) == 0
    np.testing.assert_array_equal(_pcm(out), _pcm(cli_out))


def test_post_bad_body_returns_500(url):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, "garbage", timeout=60)
    assert err.value.code == 500
    body = err.value.read()
    assert body.startswith(b"An error occurred.\n")
    assert b"Traceback" in body and b"Missing .wav" in body


def test_burst_merges_into_phrase_renders(url, src, tmp_path, monkeypatch):
    """8 concurrent POSTs: at most 2 dispatches, no fallback, and every
    WAV equals render_phrase of its batch in the batcher's order (a
    batch below MIN_PHRASE: the CLI render)."""
    batcher = server._batcher
    batches = []
    render = batcher._render
    monkeypatch.setattr(batcher, "_render", lambda batch: (
        batches.append([r.args for r in batch]), render(batch)))
    fallbacks = batcher.fallback_count
    outs = [tmp_path / f"burst{j}.wav" for j in range(8)]
    pitches = ("C4", "D4", "E4", "G4")
    bodies = [" ".join(_args(src, out, pitches[j % 4],
                             "" if j % 2 else "t10sg30", 250 + 20 * j))
              for j, out in enumerate(outs)]
    errors = []

    def post(body):
        try:
            assert _post(url, body) == 200
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=post, args=(b,)) for b in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sum(len(b) for b in batches) == 8 and len(batches) <= 2
    assert max(len(b) for b in batches) >= server.BurstBatcher.MIN_PHRASE
    assert batcher.fallback_count == fallbacks
    for batch in batches:
        if len(batch) < server.BurstBatcher.MIN_PHRASE:
            for args in batch:
                alone = tmp_path / "alone.wav"
                assert cli.main([args[0], str(alone)] + args[2:]) == 0
                np.testing.assert_array_equal(_pcm(args[1]), _pcm(alone))
            continue
        want = phrase.render_phrase(
            [phrase.NoteSpec(a[0], *a[2:]) for a in batch], pcm16=True,
            bucket=True, device="cpu")
        for args, w in zip(batch, want):
            np.testing.assert_array_equal(_pcm(args[1]), w)


def test_se1_takes_the_direct_path(url, src, tmp_path):
    sizes = list(server._batcher.batch_sizes)
    out = tmp_path / "se1.wav"
    assert _post(url, " ".join(_args(src, out, flags="SE1"))) == 200
    assert server._batcher.batch_sizes == sizes
    cli_out = tmp_path / "cli.wav"
    assert cli.main(_args(src, cli_out, flags="SE1")) == 0
    np.testing.assert_array_equal(_pcm(out), _pcm(cli_out))


def test_concurrent_requests_on_a_fresh_source(url, tmp_path, monkeypatch):
    """Four requests at once on a source without a .goofy, two on the
    SE1 path in handler threads and two through the batcher: the source
    is analysed once, its cache is whole, every request renders."""
    fresh = tmp_path / "fresh.wav"
    shutil.copy(VOICE / "src.wav", fresh)
    calls = []
    extract = resampler._extract_and_save
    monkeypatch.setattr(resampler, "_extract_and_save", lambda *a: (
        calls.append(a[0]), extract(*a))[1])
    outs = [tmp_path / f"fresh{j}.wav" for j in range(4)]
    errors = []

    def post(j):
        try:
            flags = "SE1" if j % 2 else ""
            assert _post(url, " ".join(_args(fresh, outs[j], flags=flags))
                         ) == 200
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=post, args=(j,)) for j in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # switch threads often: races show
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert calls == [fresh]
    assert sorted(p.name for p in tmp_path.iterdir()
                  if "fresh_features" in p.name) == ["fresh_features.goofy"]
    assert resampler.load_features(tmp_path / "fresh_features.goofy")[4] == \
        44100
    for out in outs:
        y = _pcm(out)
        assert y.size > 0 and np.abs(y).max() > 1000


def test_burst_fallback_is_counted_and_logged(monkeypatch, caplog):
    """A failing phrase render is logged and counted before the per-note
    fallback serves every request."""
    def boom(notes, **kw):
        raise RuntimeError("poisoned phrase path")

    monkeypatch.setattr(phrase, "render_phrase", boom)
    rendered = []
    b = server.BurstBatcher()
    monkeypatch.setattr(b, "_render_one", lambda req: (rendered.append(req),
                                                       req.done.set()))
    batch = [server._Request(["a.wav", "b.wav"]) for _ in range(4)]
    with caplog.at_level(logging.ERROR, logger="goofer_tpu_torch"):
        b._render(batch)
    assert any("burst phrase render failed" in r.message
               for r in caplog.records)
    assert b.fallback_count == 1 and b.batch_sizes == [4]
    assert len(rendered) == 4


def test_run_needs_the_device(monkeypatch):
    """Without CUDA and without $GOOFER_TPU_TORCH_DEVICE the server does
    not start; it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GOOFER_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.run(port=0, warmup=False)
    assert cli.main([]) == 1

"""The PyTorch port's facade (hutoken_tpu_torch/__init__.py) against
tests/test_facade.py's expectations: the same error strings and types,
the same results, plus the ``device=`` contract and a JAX-free import."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import fixture_tools as ft  # noqa: E402
import hutoken_tpu_torch as hutoken  # noqa: E402
from hutoken_tpu import oracle  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_port_facade():
    hutoken._reset()
    yield
    hutoken._reset()


def _init_fixture(**kw):
    vocab_path, special_path = ft.write_byte_level_fixture()
    hutoken.initialize(vocab_path, special_path, is_byte_encoder=True, **kw)


@pytest.mark.parametrize(
    "call,msg",
    [
        (lambda: hutoken.encode("szia"), "not initialized for encoding"),
        (lambda: hutoken.batch_encode(["szia"]), "not initialized for encoding"),
        (lambda: hutoken.decode([1, 2, 3]), "not initialized for decoding"),
        (lambda: hutoken.batch_decode([[1]]), "not initialized for decoding"),
    ],
)
def test_uninitialized_calls_raise(call, msg):
    with pytest.raises(RuntimeError, match=msg + r"\. Call 'initialize_"):
        call()


def test_initialize_errors(tmp_path):
    bad = tmp_path / "invalid-vocab.txt"
    bad.write_text("invalid_line_format\n")
    special = tmp_path / "s.txt"
    special.write_text("32 == X\n")
    with pytest.raises(ValueError, match="Invalid format in vocab file."):
        hutoken.initialize(str(bad), str(special))
    vocab_path, _ = ft.write_byte_level_fixture()
    with pytest.raises(ValueError, match="does not exist"):
        hutoken.initialize(vocab_path, str(tmp_path / "nope.txt"))
    with pytest.raises(TypeError, match="special_file_path"):
        hutoken.initialize(vocab_path, special_file_path="x")


def test_decode_invalid_tokens():
    _init_fixture(backend="host")
    with pytest.raises(
        ValueError, match="Element must be non-negative and less than vocab size."
    ):
        hutoken.decode([999999, -1, 50258])


@pytest.mark.parametrize("backend", ["host", "auto", "device"])
def test_encode_decode_roundtrip(backend):
    _init_fixture(backend=backend, device="cpu")
    enc = ft.tiktoken_encoding() if backend == "host" else None
    text = "Egy szűk utcában öt gyors róka szaladt át."
    ids = hutoken.encode(text)
    assert ids == (enc.encode(text) if enc else oracle.encode(hutoken._ctx, text))
    assert hutoken.decode(ids) == text


@pytest.mark.parametrize("backend", ["host", "auto"])
def test_batch_paths(backend):
    _init_fixture(backend=backend, device="cpu")
    batch = ["What I cannot", " create, I do", " not understand."]
    out = hutoken.batch_encode(batch, num_threads=3)
    assert out == [oracle.encode(hutoken._ctx, t) for t in batch]
    assert hutoken.decode(sum(out, [])) == "".join(batch)
    assert hutoken.batch_decode(out, 3) == batch
    assert (hutoken._engine is not None) == (backend == "auto")


def test_batch_decode_empty_raises():
    _init_fixture(backend="host")
    with pytest.raises(RuntimeError, match="No tokens provided."):
        hutoken.batch_decode([])


def test_device_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _init_fixture()  # device defaults to "cuda"
    assert hutoken.encode("the") == oracle.encode(hutoken._ctx, "the")  # auto: host
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        hutoken.batch_encode(["the"])


def test_encode_embedded_null_raises():
    _init_fixture(backend="auto", device="cpu")
    with pytest.raises(RuntimeError, match="embedded null character"):
        hutoken.encode("a\x00b")
    with pytest.raises(RuntimeError, match="embedded null character"):
        hutoken.batch_encode(["ok", "a\x00b"])


def test_train_arg_validation_and_mesh():
    with pytest.raises(
        RuntimeError, match="vocab_size must be at least 256 to encode all bytes."
    ):
        hutoken.bpe_train("abc", 100, "v.txt")
    with pytest.raises(
        RuntimeError, match="vocab_file_name file extension must be .txt."
    ):
        hutoken.bbpe_train("abc", 300, "vocab.bin")
    for train in (hutoken.bpe_train, hutoken.bbpe_train):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
            train("abc", 300, "v.txt", mesh=object())


def test_foma_unavailable_raises():
    with pytest.raises(RuntimeError, match="Foma support is not installed"):
        hutoken.initialize_foma()
    with pytest.raises(RuntimeError, match="Foma support is not installed"):
        hutoken.look_up_word(None, "ház")


def test_import_and_encode_leave_jax_unloaded(tmp_path):
    """tests/conftest.py imports jax into this process, so the check
    runs in a fresh interpreter; it covers initialize, the word pipeline
    and the raw path (whose JAX counterpart imports jax when it runs),
    batch decode and both trainers: neither ``jax`` nor any module of
    the JAX package ``hutoken_tpu`` loads."""
    v, s = ft.write_byte_level_fixture()
    code = (
        "import os, sys, torch; torch.set_num_threads(1)\n"
        "import hutoken_tpu_torch as ht\n"
        f"ht.initialize({v!r}, {s!r}, is_byte_encoder=True, device='cpu')\n"
        "out = ht.batch_encode(['a gyors barna róka', ' The quick brown fox'])\n"
        "assert out and all(out), out\n"
        "assert ht._engine is not None and ht._engine._raw_enc is None\n"
        "os.environ['HUTOKEN_TPU_RAW'] = '1'\n"
        "assert ht.batch_encode(['a gyors barna róka', ' The quick brown fox']) == out\n"
        "assert ht._engine._raw_enc is not None and ht._engine.stat_device_bytes > 0\n"
        "assert ht.batch_decode(out) == ['a gyors barna róka', ' The quick brown fox']\n"
        "assert os.path.isfile(ht.bpe_train('a gyors barna róka ' * 20, 260, 'b.txt', verbose=False))\n"
        "assert os.path.isfile(ht.bbpe_train('a gyors barna róka ' * 20, 260, 'bb.txt', verbose=False))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'hutoken_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, HOME=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    # the trainers print where they saved the vocabulary
    assert proc.returncode == 0 and proc.stdout.strip().splitlines()[-1] == "ok", proc.stderr

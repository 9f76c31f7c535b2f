"""hutoken-tpu on PyTorch and CUDA: the module facade.

The same API as ``hutoken_tpu`` (``initialize``, ``encode``,
``batch_encode``, ``decode``, ``batch_decode``, ``bpe_train``,
``bbpe_train``, ``initialize_foma``, ``look_up_word``) over a
process-global tokenizer, with the same error strings.  Batch encode
runs on :class:`hutoken_tpu_torch.engine.TorchTokenizer`.

``initialize`` takes one keyword beyond the JAX facade: ``device``
(default ``"cuda"``).  Without a CUDA device, a call that needs the
device engine raises unless ``device="cpu"`` was given; nothing falls
back to the host quietly.

Backend (``backend=`` or env ``HUTOKEN_TPU_BACKEND``):

* ``device`` — every encode goes to the device engine,
* ``host``   — the native C++ engine or the scalar oracle,
* ``auto``   — batch encode on the device, single encode on the host.

Decode routes as the JAX facade's does.  Under ``device`` both
``decode`` and ``batch_decode`` go to the engine, which decodes on the
device (``HUTOKEN_TPU_DECODE`` may still send it to its host path);
under ``auto`` ``batch_decode`` goes there only with
``HUTOKEN_TPU_DECODE=device``, since the engine's default decode is the
native host decode that ``auto`` runs anyway and building the engine
needs the device.  Everything else decodes on the host.

The trainers run on the host, except with ``mesh=``: with
``mesh=parallel.data_mesh()`` the merge loop of ``bbpe_train`` or
``bpe_train`` runs on the card (``parallel/train.py``), and the vocab is
the host's (``bpe_train``'s that of ``strict=False``).  The package
imports nothing of JAX and nothing of the JAX package ``hutoken_tpu``:
it keeps its own copies of the host modules it needs.
"""

from __future__ import annotations

# the set-up record's first stamp, before the package imports anything
from .setup_record import SETUP as _SETUP

_SETUP.stamp("package", full=True)

import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Any, Optional  # noqa: E402

from . import oracle  # noqa: E402
from .context import TokenizerContext  # noqa: E402
from .spans import RECORD as _SPANS  # noqa: E402
from .spans import pinned_bytes as _pinned_bytes  # noqa: E402
from .utils.logging import initialize_logging, log_debug

# the set-up record reads the pinned allocator from here on
_SETUP.read_pinned = _pinned_bytes

__version__ = "0.1.0"

_ctx: Optional[TokenizerContext] = None
_engine = None  # device engine bound to _ctx, built at first use
_native = None
_native_failed = False
_backend = "auto"
_device = "cuda"

_ENCODE_UNINIT_MSG = (
    "Vocabulary is not initialized for encoding. "
    "Call 'initialize_encode' function first."
)
_DECODE_UNINIT_MSG = (
    "Vocabulary is not initialized for decoding. "
    "Call 'initialize_decode' function first."
)

def _reset() -> None:
    global _ctx, _engine, _native, _native_failed
    _ctx = None
    _engine = None
    _native = None
    _native_failed = False


def initialize(model_or_path: str, *args: Any, **kwargs: Any):
    """Initialize the global tokenizer from a vocab file path or a Hugging
    Face model id, as ``hutoken_tpu.initialize`` does.

    Extra keyword: ``device`` (``"cuda"``, ``"cuda:N"`` or ``"cpu"``),
    where the batch engine runs.
    """
    global _ctx, _backend, _device
    initialize_logging()
    from .utils.mem import tune_allocator

    tune_allocator()
    _backend = kwargs.pop("backend", os.environ.get("HUTOKEN_TPU_BACKEND", "auto"))
    _device = kwargs.pop("device", "cuda")

    if os.path.isfile(model_or_path):
        unknown = set(kwargs) - {
            "prefix", "is_byte_encoder", "token_id", "pattern",
            "merges_file_path",
        }
        if unknown:
            raise TypeError(
                f"'{sorted(unknown)[0]}' is an invalid keyword argument "
                "for initialize()"
            )
        special_chars_file = args[0] if args else None
        merges_file = kwargs.get("merges_file_path", None)
        if len(args) > 6 and merges_file is None:
            merges_file = args[6]
        if special_chars_file and not os.path.isfile(special_chars_file):
            raise ValueError(
                f"Special characters file '{special_chars_file}' does not exist."
            )
        if merges_file and not os.path.isfile(merges_file):
            raise ValueError(
                f"The provided merges file '{merges_file}' does not exist."
            )
        _reset()
        with _SETUP.stage("context"):
            _ctx = TokenizerContext.load(
                model_or_path,
                special_chars_file,
                prefix=kwargs.get("prefix", None),
                is_byte_encoder=kwargs.get("is_byte_encoder", False),
                pattern=kwargs.get("pattern", None),
                merges_file_path=merges_file,
            )
        return None

    from .hf_import import import_hf_tokenizer  # optional dependency

    vocab_file, special_chars_file, prefix, is_byte_encoder, merges_file_path = (
        import_hf_tokenizer(model_or_path)
    )
    try:
        _reset()
        with _SETUP.stage("context"):
            _ctx = TokenizerContext.load(
                vocab_file,
                special_chars_file,
                prefix=prefix,
                is_byte_encoder=is_byte_encoder,
                pattern=kwargs.get("pattern", None),
                merges_file_path=merges_file_path,
            )
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        raise RuntimeError(
            f"An unexpected error occured during initialization: {e}"
        ) from e
    return None


def _get_engine():
    """The device engine for the current context (raises when the
    requested device is unavailable: no host fallback)."""
    global _engine
    if _engine is None:
        from .engine import TorchTokenizer

        _engine = TorchTokenizer(
            _ctx, device=_device, prefer_device_decode=(_backend == "device")
        )
    return _engine


def _get_native():
    """The native C++ host engine; None if the library is unavailable."""
    global _native, _native_failed
    if _native is None and not _native_failed:
        try:
            from .native import NativeEngine

            _native = NativeEngine(_ctx)
        except Exception as e:
            log_debug("native host engine unavailable: %s", e)
            _native_failed = True
    return _native


def _use_device(batch: bool) -> bool:
    if _backend == "host":
        return False
    return _backend == "device" or batch


def _decode_on_engine(batch: bool) -> bool:
    """Whether a decode goes to the engine: always under ``device``, and
    a batch under ``auto`` when ``HUTOKEN_TPU_DECODE=device``.  The JAX
    facade also sends every ``auto`` batch there, whose engine then
    decodes on the native host path; the port skips the engine in that
    case, because building it needs the device."""
    if _backend == "device":
        return True
    return (
        batch and _backend == "auto"
        and os.environ.get("HUTOKEN_TPU_DECODE") == "device"
    )


def _encode_host(texts: list[str], num_threads: int) -> list[list[int]]:
    native = _get_native()
    if native is not None and native.supports_pattern:
        return native.encode_batch(texts, num_threads)
    return [oracle.encode(_ctx, t) for t in texts]


def _decode_host(tokens: list[list[int]], num_threads: int) -> list[str]:
    native = _get_native()
    if native is not None:
        return native.decode_batch(tokens, num_threads)
    return [oracle.decode(_ctx, t) for t in tokens]


def encode(text: str) -> list[int]:
    """Encode one document."""
    if _ctx is None:
        raise RuntimeError(f"hutoken: Error encoding text: {_ENCODE_UNINIT_MSG}")
    try:
        if _use_device(batch=False):
            return _get_engine().encode_batch([text])[0]
        return _encode_host([text], 1)[0]
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        raise RuntimeError(f"hutoken: Error encoding text: {e}") from e


def batch_encode(texts: list[str], num_threads: int = 1) -> list[list[int]]:
    """Encode a batch of documents.  ``num_threads`` applies to the host
    backend; the device engine has its own pipeline threads.  Under a
    ``torch.profiler`` the call is traced as ``facade.batch_encode``
    (``spans.py``), and its end reads the span record's gauges; the
    process's first untraced calls are stamped in the set-up record
    (``setup_record.py``)."""
    if _ctx is None:
        raise RuntimeError(f"hutoken: Error encoding texts: {_ENCODE_UNINIT_MSG}")
    try:
        with _SPANS.entry("facade.batch_encode", gauges=True) as tr, \
                _SETUP.call(tr is not None):
            if _use_device(batch=True):
                return _get_engine().encode_batch(texts)
            if tr:
                tr.count("path.host")
            return _encode_host(texts, num_threads)
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        raise RuntimeError(f"hutoken: Error encoding texts: {e}") from e


def decode(tokens: list[int]) -> str:
    """Decode one token list."""
    if _ctx is None:
        raise RuntimeError(f"hutoken: Error decoding tokens: {_DECODE_UNINIT_MSG}")
    try:
        if _decode_on_engine(batch=False):
            return _get_engine().decode_batch([list(tokens)])[0]
        return _decode_host([list(tokens)], 1)[0]
    except ValueError as e:
        traceback.print_exc(file=sys.stderr)
        raise ValueError(f"hutoken: Error decoding tokens {tokens}: {e}") from e
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        raise RuntimeError(f"hutoken: Error decoding tokens: {e}") from e


def batch_decode(tokens: list[list[int]], num_threads: int = 1) -> list[str]:
    """Decode a batch."""
    if _ctx is None:
        raise RuntimeError(f"hutoken: Error decoding tokens: {_DECODE_UNINIT_MSG}")
    try:
        if len(tokens) <= 0:
            raise ValueError("No tokens provided.")
        if _decode_on_engine(batch=True):
            return _get_engine().decode_batch(
                [list(t) for t in tokens], num_threads=num_threads
            )
        return _decode_host([list(t) for t in tokens], num_threads)
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        raise RuntimeError(f"hutoken: Error decoding tokens: {e}") from e


def bpe_train(data: str, vocab_size: int, vocab_file_name: str, **kwargs: Any):
    """Train a BPE vocab: on the host (``strict=False`` disables the
    reference-bug emulation, see ``train/bpe.py``), or with
    ``mesh=parallel.data_mesh()`` on the card, where it writes what
    ``strict=False`` writes (``parallel/train.py``; ``data_mesh(n,
    device="cpu")`` shards it on the CPU)."""
    from .train.bpe import bpe_train as _bpe_train

    _validate_train_args(vocab_size, vocab_file_name)
    return _bpe_train(data, vocab_size, vocab_file_name, **kwargs)


def bbpe_train(data: str, vocab_size: int, vocab_file_name: str, **kwargs: Any):
    """Train a byte-level BPE vocab: on the host, or with
    ``mesh=parallel.data_mesh()`` on the card (``parallel/train.py``;
    ``data_mesh(n, device="cpu")`` shards it on the CPU).  Both write
    the same vocab file."""
    from .train.bbpe import bbpe_train as _bbpe_train

    _validate_train_args(vocab_size, vocab_file_name)
    return _bbpe_train(data, vocab_size, vocab_file_name, **kwargs)


def _validate_train_args(vocab_size: int, vocab_file_name: str) -> None:
    if vocab_size < 256:
        raise RuntimeError("vocab_size must be at least 256 to encode all bytes.")
    if len(vocab_file_name) < 4 or not vocab_file_name.endswith(".txt"):
        raise RuntimeError("vocab_file_name file extension must be .txt.")


def initialize_foma():
    """Load the foma/emMorph FST."""
    from . import morphology

    if not morphology.available():
        raise RuntimeError(
            "hutoken: '_hutoken' does not provide 'initialize_foma' "
            "or Foma support is not installed."
        )
    return morphology.initialize_foma()


def look_up_word(handle, word: str, only_longest: bool = False):
    """Morphological analysis of a word."""
    from . import morphology

    if not morphology.available():
        raise RuntimeError(
            "hutoken: '_hutoken' does not provide 'look_up_word' "
            "or Foma support is not installed."
        )
    return morphology.look_up_word(handle, word, only_longest)

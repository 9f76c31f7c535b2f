"""Table gathers on int32 tables: the hand-written CUDA kernels of
``csrc/gather.cu`` and their plain PyTorch twins.

The kernels replace the Pallas gather probes of the TPU's profiling
scripts (``scripts/profile_pallas_gather.py`` ``k_take`` / ``k_taa``,
``scripts/profile_pallas_gather2.py`` ``k_gather2``,
``scripts/profile_gather3.py`` ``kernel`` / ``kernel0``); the source file
says how each is laid out for Hopper.  ``python -m
hutoken_tpu_torch.scripts.profile_gather`` runs them at the scripts'
shapes.

Each entry point launches its kernel for CUDA tensors and runs its twin
only for CPU tensors: there is no fallback from one to the other.  The
launch plans of the redesigned kernels (:func:`gather_1d_plan`,
:func:`gather_rows_plan`, :func:`gather_cols_plan`) are plain functions
passed to the C entry points, so that the CPU tests can check them.
Indices must be in range, as the TPU kernels assume; the kernels do not
check them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from .build import build_library

LANES = 128  # the TPU's lane width, which fixes the two-level layout
# The launch geometry of the planned kernels, which csrc/gather.cu takes
# from the plans and keeps no copy of.
THREADS = 256  # the block of gather_1d and gather_rows
SLAB_THREADS = 512  # gather_cols' slab block: one block per SM
TMA_WIDTHS = (32, 16, 8)  # gather_cols' slab widths, widest first
BOX_ROWS = 256  # table rows of a TMA box (at most 256)
BAR_BYTES = 16  # the mbarrier's room in a block's shared memory
# gather_cols takes the slab route up to this many table rows and the L2
# route past it: the crossover of the two, measured on an H100 (gather.cu)
SLAB_MAX_ROWS = 5632
L2_THREADS = 256  # gather_cols' L2 route: at most a block of this many threads per index row
L2_MAX_BLOCKS = 1 << 20  # ... and at most this many blocks, striding over the rows


def build() -> str:
    """Compile the kernels (once per digest of their source); returns the
    shared library's path."""
    return build_library("gather")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    i32, u32 = ctypes.c_int, ctypes.c_uint32
    for name in ("ht_gather_smem_limit", "ht_gather_rows_vectors"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    for name, args in (
        ("ht_gather_1d_blocks_per_sm", [i32, i32, i64, ctypes.POINTER(ctypes.c_int)]),
        ("ht_gather_1d", [p, i64, i32, i32, i32, p, i64, i32, i32, i32, i32, i64, i64, p, p]),
        ("ht_gather_two_level", [p, p, i64, p, p]),
        ("ht_gather_rows", [p, i64, p, i64, i32, i32, i32, i64, i64, i64, u32, i32, p, p]),
        ("ht_gather_cols", [p, i64, i64, p, i64, i32, i32, i32, i32, i32, i32, i64, i64, p, p]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    """Bytes of shared memory a block may opt in to on that card."""
    with torch.cuda.device(device_index):
        return _library().ht_gather_smem_limit()


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, smem: bool, smem_bytes: int) -> int:
    """gather_1d blocks that fit on one SM of that card at once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _library().ht_gather_1d_blocks_per_sm(int(smem), THREADS, smem_bytes,
                                                   ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"gather_1d occupancy query failed: CUDA error {rc}")
    return max(per_sm.value, 1)


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _lead(addr: int) -> int:
    """int32 entries from ``addr`` to the next 16-byte boundary (0-3)."""
    return (-addr % 16) // 4


@dataclass(frozen=True)
class Gather1dPlan:
    """How :func:`gather_1d`'s kernel covers ``n`` lookups: block 0 looks
    up indices ``[0, head)`` and ``[head + 4 * vectors, n)`` one by one;
    block ``b`` of ``blocks`` blocks of ``threads`` threads the 16-byte
    vectors ``[b * per_block, (b + 1) * per_block)`` of the ``vectors``
    that start at index ``head``.  Staging, ``smem_bytes`` of shared
    memory hold table entry ``i`` at int32 ``stage_at + i``, so that the
    bulk copy's first entry, ``lead``, lands on a 16-byte boundary, and
    the mbarrier at int32 ``bar_at``, the first 16-byte boundary after
    the table."""

    head: int
    vectors: int
    blocks: int
    threads: int
    per_block: int
    lead: int
    stage_at: int
    bar_at: int
    smem_bytes: int


def _stage_layout(table_len: int, table_addr: int) -> tuple[int, int]:
    """The int32s of shared memory where the staged table's entry 0 and
    the mbarrier go."""
    stage_at = (4 - _lead(table_addr)) % 4
    return stage_at, -(-(stage_at + table_len) // 4) * 4


def gather_1d_smem_bytes(table_len: int, table_addr: int) -> int:
    """Shared memory the staging kernel takes for this table."""
    return 4 * _stage_layout(table_len, table_addr)[1] + BAR_BYTES


def gather_1d_plan(n: int, table_len: int, smem: bool, idx_addr: int, table_addr: int,
                   sms: int, per_sm: int) -> Gather1dPlan:
    """The launch plan of :func:`gather_1d` for ``n`` indices at
    ``idx_addr`` (the output at the same address mod 16) into a table of
    ``table_len`` entries at ``table_addr``, on a card of ``sms`` SMs that
    fit ``per_sm`` blocks each.

    Through L2, a block per 256 vectors, at most one wave.  Staging, each
    block copies the whole table, so there are as many blocks as gather
    at least ``table_len`` indices each (staging then moves no more
    bytes than the gather), but at least one per SM while the vectors
    last, and at most one wave."""
    head = min(_lead(idx_addr), n)
    vectors = (n - head) // 4
    by_threads = -(-vectors // THREADS)
    if smem:
        blocks = max(-(-n // max(table_len, 1)), min(sms, by_threads))
    else:
        blocks = by_threads
    blocks = max(1, min(blocks, sms * per_sm, max(vectors, 1)))
    per_block = -(-vectors // blocks)
    if per_block:
        blocks = -(-vectors // per_block)
    lead = _lead(table_addr) if smem else 0
    stage_at, bar_at = _stage_layout(table_len, table_addr) if smem else (0, 0)
    smem_bytes = gather_1d_smem_bytes(table_len, table_addr) if smem else 0
    return Gather1dPlan(head, vectors, blocks, THREADS, per_block, lead, stage_at, bar_at,
                        smem_bytes)


@dataclass(frozen=True)
class RowDivider:
    """How :func:`gather_rows`' kernel finds the row ``i // L`` of flat
    lookup ``i``: with ``magic`` > 0 (every ``i`` < 2^31), the 32-bit
    multiply-high division ``(umulhi(i, magic) + i) >> shift``; else a
    64-bit division."""

    L: int
    magic: int
    shift: int

    def __call__(self, i: int) -> int:
        """``i // L`` by the kernel's arithmetic (``RowOf`` in gather.cu)."""
        if self.magic:
            if not 0 <= i < 1 << 31:
                raise ValueError(f"the multiply-high division takes i < 2^31, got {i}")
            t = (i * self.magic) >> 32  # __umulhi
            return ((t + i) & 0xFFFFFFFF) >> self.shift
        return i // self.L


def row_divider(L: int, n: int) -> RowDivider:
    """The row divider of ``n`` flat lookups in rows of ``L`` (1 <= L <
    2^31): the multiply-high division while ``n`` <= 2^31, exact for every
    dividend below 2^31 (``s`` the least with ``2^s >= L``, ``magic =
    2^32 (2^s - L) // L + 1``; 1 where L is a power of two, which makes it
    a shift), a 64-bit division past that."""
    if n > 1 << 31:
        return RowDivider(L, 0, 0)
    s = (L - 1).bit_length()
    return RowDivider(L, ((1 << 32) * ((1 << s) - L)) // L + 1, s)


@dataclass(frozen=True)
class GatherRowsPlan:
    """How :func:`gather_rows`' kernel covers ``[W, L]`` indices taken as
    ``n = W * L`` flat lookups, with :func:`gather_1d`'s loop: block 0
    looks up indices ``[0, head)`` and ``[head + 4 * vectors, n)`` one by
    one; block ``b`` of ``blocks`` blocks of ``threads`` threads the
    16-byte vectors ``[b * per_block, (b + 1) * per_block)`` of the
    ``vectors`` that start at index ``head``, through ``smem_bytes`` of
    shared memory (each warp's ``row_vectors`` x 128 int32); ``row`` finds
    each lookup's row of ``R``."""

    head: int
    vectors: int
    blocks: int
    threads: int
    per_block: int
    smem_bytes: int
    row: RowDivider


def gather_rows_plan(W: int, L: int, idx_addr: int, row_vectors: int) -> GatherRowsPlan:
    """The launch plan of :func:`gather_rows` for ``[W, L]`` indices at
    ``idx_addr`` (the output at the same address mod 16), for a kernel
    whose threads gather ``row_vectors`` 16-byte vectors at once: the
    scalar head and tail that align the vectors, a block per ``THREADS x
    row_vectors`` vectors (one pass of its threads), however many waves
    that takes, and :func:`row_divider`.  A wave-bound grid, whose blocks
    each take a long run of rows, spread each wave's random reads over
    all of ``R`` and ran slower on the H100 (gather.cu)."""
    n = W * L
    head = min(_lead(idx_addr), n)
    vectors = (n - head) // 4
    per_block = THREADS * row_vectors
    return GatherRowsPlan(head, vectors, max(1, -(-vectors // per_block)), THREADS, per_block,
                          THREADS // 32 * row_vectors * LANES * 4, row_divider(L, n))


@dataclass(frozen=True)
class GatherColsPlan:
    """How :func:`gather_cols`' kernel covers a ``[rows, width]`` index
    array.  Slab route (``k`` > 0): block ``(x, s)`` of a ``row_splits``
    x ``slabs`` grid of ``threads``-thread blocks gathers table columns
    ``[s * k, min((s + 1) * k, width))`` for index rows ``[x * rows_per,
    min((x + 1) * rows_per, rows))`` from a slab of those columns, which
    arrives by TMA in ``boxes`` boxes of ``box_rows`` table rows;
    ``smem_bytes`` of shared memory hold the slab and then the mbarrier.
    L2 route (``k`` 0): block ``x`` of ``row_splits`` takes index rows
    ``x, x + row_splits, ...``, thread ``t`` of ``threads`` the columns
    ``t, t + threads, ...``; no shared memory."""

    k: int
    boxes: int
    box_rows: int
    slabs: int
    row_splits: int
    threads: int
    rows_per: int
    smem_bytes: int


def l2_route(width: int, rows: int) -> GatherColsPlan:
    """:func:`gather_cols`' L2 route for ``[rows, width]`` indices: a
    block per index row (at most ``L2_MAX_BLOCKS``), a thread per column
    (at most ``L2_THREADS``, a warp multiple)."""
    threads = min(L2_THREADS, max(32, -(-width // 32) * 32))
    return GatherColsPlan(0, 0, 0, 1, max(1, min(rows, L2_MAX_BLOCKS)), threads, 0, 0)


def slab_plan(table_rows: int, width: int, rows: int, sms: int,
              smem_limit: int) -> Optional[GatherColsPlan]:
    """:func:`gather_cols`' slab route for a ``[table_rows, width]``
    table (width a multiple of 4) and ``[rows, width]`` indices: the
    widest slab of ``TMA_WIDTHS`` whose padded table columns fit
    ``smem_limit`` (a wider slab reads fewer, fuller index and output
    rows per lookup), about one block per SM over all slabs; None if no
    slab fits."""
    boxes = -(-table_rows // BOX_ROWS)
    fits = [k for k in TMA_WIDTHS if boxes * BOX_ROWS * k * 4 + BAR_BYTES <= smem_limit]
    if not fits:
        return None
    k = min(fits[0], width)
    slabs = -(-width // k)
    rows = max(rows, 1)
    rows_per = -(-rows // max(1, min(rows, sms // slabs)))
    if rows_per * k >= 1 << 31:
        raise ValueError(f"gather_cols: {rows_per} index rows a block do not fit 32-bit counts")
    return GatherColsPlan(k, boxes, BOX_ROWS, slabs, -(-rows // rows_per), SLAB_THREADS, rows_per,
                          boxes * BOX_ROWS * k * 4 + BAR_BYTES)


def gather_cols_plan(table_rows: int, width: int, rows: int, aligned: bool,
                     sms: int, smem_limit: int) -> GatherColsPlan:
    """The launch plan of :func:`gather_cols` for a ``[table_rows, width]``
    table and ``[rows, width]`` indices, ``aligned`` if the table, the
    indices and the output start on 16-byte boundaries, on a card of
    ``sms`` SMs whose blocks may take ``smem_limit`` bytes of shared
    memory.

    :func:`slab_plan` for aligned tensors of a width that is a multiple
    of 4 and a table of at most ``SLAB_MAX_ROWS`` rows whose slab fits;
    :func:`l2_route` for every other input."""
    if aligned and width % 4 == 0 and table_rows <= SLAB_MAX_ROWS:
        plan = slab_plan(table_rows, width, rows, sms, smem_limit)
        if plan is not None:
            return plan
    return l2_route(width, rows)


def _check(name: str, *pairs) -> torch.device:
    """All tensors int32, on one device; returns it."""
    dev = pairs[0][1].device
    for what, t in pairs:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {what} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, expected {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _launch(name: str, fn, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def gather_1d(table: torch.Tensor, idx: torch.Tensor, smem: bool) -> torch.Tensor:
    """``table[idx]`` for an int32 table ``[C]`` and int32 indices of any
    shape.  ``smem=False`` reads the table through L2 (the counterpart of
    ``k_take``); ``smem=True`` stages it in shared memory first (the
    counterpart of ``k_taa``) and raises if ``C`` does not fit.

    A CUDA tensor launches the kernel with :func:`gather_1d_plan`'s plan
    on the current stream without synchronising and adds one to
    ``gather_1d.launches_by_mode["smem" | "l2"]``; its output starts at
    the indices' address mod 16 (a view into a buffer 3 entries longer
    when the indices are a view at such an offset).  A CPU tensor runs
    :func:`gather_1d_plain`.
    """
    dev = _check("gather_1d", ("table", table), ("idx", idx))
    if table.dim() != 1:
        raise ValueError(f"gather_1d: table must be 1-D, got {tuple(table.shape)}")
    if dev.type == "cpu":
        return gather_1d_plain(table, idx)
    table, idx = table.contiguous(), idx.contiguous()
    di = _index(dev)
    C, n = table.numel(), idx.numel()
    smem_bytes = gather_1d_smem_bytes(C, table.data_ptr()) if smem else 0
    if smem and smem_bytes > _smem_limit(di):
        raise ValueError(
            f"gather_1d: a table of {C} int32 does not fit the "
            f"{_smem_limit(di)} bytes of shared memory a block may use"
        )
    out = _same_alignment(idx, dev)
    if n == 0 or C == 0:
        return out
    plan = gather_1d_plan(n, C, smem, idx.data_ptr(), table.data_ptr(), _sm_count(di),
                          _blocks_per_sm(di, smem, smem_bytes))
    _launch("gather_1d", _library().ht_gather_1d, dev, table.data_ptr(), C, plan.lead,
            plan.stage_at, plan.bar_at, idx.data_ptr(), n, plan.head, int(smem), plan.blocks,
            plan.threads,
            plan.per_block, plan.smem_bytes, out.data_ptr())
    gather_1d.launches_by_mode["smem" if smem else "l2"] += 1
    return out


gather_1d.launches_by_mode = {"l2": 0, "smem": 0}


def _same_alignment(idx: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """An empty int32 tensor of ``idx``'s shape whose address agrees with
    ``idx``'s mod 16 (a view into a buffer 3 entries longer when ``idx``
    is a view at an offset), so that one scalar peel aligns the kernel's
    16-byte index loads and output stores together."""
    if idx.data_ptr() % 16 == 0:
        return torch.empty(idx.shape, dtype=torch.int32, device=dev)
    buf = torch.empty(idx.numel() + 3, dtype=torch.int32, device=dev)
    shift = (idx.data_ptr() - buf.data_ptr()) % 16 // 4
    return buf[shift: shift + idx.numel()].view(idx.shape)


def gather_1d_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`gather_1d`: plain indexing."""
    return table[idx.to(torch.int64)]


def gather_two_level(table2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``k_gather2``'s composed gather on a ``[C/128, 128]`` table and
    ``[M, 128]`` indices: with ``rows = idx >> 7`` and ``lanes = idx &
    127``, ``out[n, l] = table2d[rows[n, lanes[n, l]], lanes[n, l]]``.
    This is NOT ``table2d.reshape(-1)[idx]`` (the script checks both).

    CUDA: the kernel, counted in ``gather_two_level.launches``; CPU:
    :func:`gather_two_level_plain`.
    """
    dev = _check("gather_two_level", ("table2d", table2d), ("idx", idx))
    if table2d.dim() != 2 or idx.dim() != 2 or table2d.shape[1] != LANES or idx.shape[1] != LANES:
        raise ValueError(
            f"gather_two_level: table2d [R, {LANES}] and idx [M, {LANES}], got "
            f"{tuple(table2d.shape)} and {tuple(idx.shape)}"
        )
    if dev.type == "cpu":
        return gather_two_level_plain(table2d, idx)
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    if idx.numel() == 0:
        return out
    table2d, idx = table2d.contiguous(), idx.contiguous()
    _launch("gather_two_level", _library().ht_gather_two_level, dev,
            table2d.data_ptr(), idx.data_ptr(), idx.shape[0], out.data_ptr())
    gather_two_level.launches += 1
    return out


gather_two_level.launches = 0


def gather_two_level_plain(table2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`gather_two_level`: the script's two
    ``take_along_axis`` steps as two ``torch.gather``s."""
    idx = idx.to(torch.int64)
    g = torch.gather(table2d, 0, idx >> 7)  # g[n, j] = t[rows[n, j], j]
    return torch.gather(g, 1, idx & (LANES - 1))


def gather_rows(R: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[w, j] = R[w, idx[w, j]]`` for ``R`` ``[W, C2]`` and ``idx``
    ``[W, L]`` (``kernel`` of ``profile_gather3.py``).

    CUDA: the kernel with :func:`gather_rows_plan`'s plan, counted in
    ``gather_rows.launches``; its output starts at the indices' address
    mod 16, as :func:`gather_1d`'s does.  CPU: :func:`gather_rows_plain`.
    """
    dev = _check("gather_rows", ("R", R), ("idx", idx))
    if R.dim() != 2 or idx.dim() != 2 or R.shape[0] != idx.shape[0]:
        raise ValueError(
            f"gather_rows: R [W, C2] and idx [W, L], got {tuple(R.shape)} and {tuple(idx.shape)}"
        )
    if dev.type == "cpu":
        return gather_rows_plain(R, idx)
    R, idx = R.contiguous(), idx.contiguous()
    out = _same_alignment(idx, dev)
    if idx.numel() == 0:
        return out
    plan = gather_rows_plan(*idx.shape, idx.data_ptr(), _library().ht_gather_rows_vectors())
    row = plan.row
    _launch("gather_rows", _library().ht_gather_rows, dev, R.data_ptr(), R.shape[1],
            idx.data_ptr(), idx.numel(), plan.head, plan.blocks, plan.threads, plan.per_block,
            plan.smem_bytes, row.L, row.magic, row.shift, out.data_ptr())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_rows_plain(R: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`gather_rows`."""
    return torch.gather(R, 1, idx.to(torch.int64))


def gather_cols(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[n, l] = tbl[idx[n, l], l]`` for ``tbl`` ``[C, K]`` and
    ``idx`` ``[M, K]`` (``kernel0`` of ``profile_gather3.py``, K = 128).

    CUDA: the kernel with :func:`gather_cols_plan`'s plan, counted in
    ``gather_cols.launches`` and by route in
    ``gather_cols.launches_by_route["slab" | "l2"]``; CPU:
    :func:`gather_cols_plain`.
    """
    dev = _check("gather_cols", ("tbl", tbl), ("idx", idx))
    if tbl.dim() != 2 or idx.dim() != 2 or tbl.shape[1] != idx.shape[1]:
        raise ValueError(
            f"gather_cols: tbl [C, K] and idx [M, K], got {tuple(tbl.shape)} and {tuple(idx.shape)}"
        )
    if dev.type == "cpu":
        return gather_cols_plain(tbl, idx)
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    if idx.numel() == 0:
        return out
    tbl, idx = tbl.contiguous(), idx.contiguous()
    di = _index(dev)
    aligned = all(t.data_ptr() % 16 == 0 for t in (tbl, idx, out))
    plan = gather_cols_plan(tbl.shape[0], tbl.shape[1], idx.shape[0], aligned,
                            _sm_count(di), _smem_limit(di))
    _launch("gather_cols", _library().ht_gather_cols, dev, tbl.data_ptr(), tbl.shape[0],
            tbl.shape[1], idx.data_ptr(), idx.shape[0], plan.k, plan.boxes, plan.box_rows,
            plan.slabs, plan.row_splits, plan.threads, plan.rows_per, plan.smem_bytes,
            out.data_ptr())
    gather_cols.launches += 1
    gather_cols.launches_by_route["slab" if plan.k else "l2"] += 1
    return out


gather_cols.launches = 0
gather_cols.launches_by_route = {"slab": 0, "l2": 0}


def gather_cols_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`gather_cols`."""
    return torch.gather(tbl, 0, idx.to(torch.int64))


def reset_launches() -> None:
    """Set every gather kernel's launch count to 0."""
    gather_two_level.launches = gather_rows.launches = gather_cols.launches = 0
    gather_1d.launches_by_mode.update(l2=0, smem=0)
    gather_cols.launches_by_route.update(slab=0, l2=0)

"""Device byte-level BPE training on the data mesh.

The port of the bbpe trainer of ``hutoken_tpu/parallel/train.py``
(reference: src/bbpe.c:73-124).  The corpus lives sharded over the mesh
as int32 id arrays (-1 pads only at each shard's tail); each merge step

    1. counts pairs per shard: one sort on one shard
       (``count_pick_sorted``), dense ``K*K`` scatters summed over the
       shards for small vocabularies (``count_shard``), or each shard's
       top-k pairs recounted exactly across shards (``count_candidates``,
       certified per step by a Fagin-style bound, with rollback to an
       exact host pick on the rare step it cannot certify);
    2. combines the shards with ``psum`` / ``pmax`` (``collectives.py``);
    3. picks the winner by the host trainer's rule: the max count, then
       the smallest LAST-occurrence position;
    4. merges it left to right within each shard, with a carry chain for
       runs that straddle shards.

Shard boundaries are invisible: a shard's last pair takes the first
element of the nearest non-empty successor shard, so on any corpus and
any shard count ``distributed_bbpe_train`` writes what ``bbpe_train_core``
writes (``tests/test_torch_train.py``).  ``make_scan_train_step``
enqueues ``scan_steps`` merges on the device without a host sync and
downloads their stacked results once; the host replays the bookkeeping.

Each op is written as per-shard phases with the collectives between
them, where ``shard_map`` hides those boundaries in the reference.  The
string (spelling-group) trainer is not ported yet: ``distributed_bpe_train``
raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..train.common import MESH_MSG
from .collectives import all_gather, axis_index, pmax, psum
from .mesh import DataMesh, shard_batch

# torch has no multi-key sort, where the reference sorts (id1, id2, pos)
# on two keys (:176, :235): a pair is one int64 key (id1 << 31) | id2,
# which orders as (id1, id2) does since ids are non-negative and < 2^31.
# Invalid pairs (a pad on either side) take NO_PAIR and sort last.
ID_BITS = 31
ID_MASK = (1 << ID_BITS) - 1
NO_PAIR = (ID_MASK << ID_BITS) | ID_MASK
INF = 0x7FFFFFFF
MIN_MERGE_COUNT = 2  # bbpe stops at a best count <= 1 (src/bbpe.c:83-84)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, as a device gather (no host sync)."""
    return x.index_select(0, i.reshape(1).long()).reshape(())


def _last_true(flags: torch.Tensor) -> torch.Tensor:
    """The index of the last True at or before each position (-1 before
    the first): the reference's ``lax.associative_scan(jnp.maximum)``
    over ``where(flags, idx, -1)`` (:62, :181, :239).

    ``torch.cummax`` computes it, but on a 1-D CUDA tensor it runs one
    thread block: 10 ms per 4 M ids on the card, 94 % of a merge
    (``PERF.md`` section 6).  So a cumsum ranks the Trues, the True
    positions are scattered into a table by rank (the others to slots of
    their own past ``n``, so no two writes meet) and gathered back."""
    n = flags.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=flags.device)
    rank = torch.cumsum(flags, 0, dtype=torch.int32) - 1
    table = torch.empty(2 * n, dtype=torch.int32, device=flags.device)
    table.scatter_(0, torch.where(flags, rank, n + idx).long(), idx)
    return torch.where(rank >= 0, table.index_select(0, rank.clamp(min=0)), -1)


def _merge_mask_device(match: torch.Tensor) -> torch.Tensor:
    """Left-to-right non-overlapping selection of matched pair positions
    (device version of ``train.common.left_to_right_merge_mask``):
    ``match[i]`` at an even offset within its run of matches."""
    idx = torch.arange(match.shape[0], dtype=torch.int32, device=match.device)
    prev = torch.cat([match.new_zeros(1), match[:-1]])
    start = _last_true(match & ~prev)
    return match & (((idx - start) & 1) == 0)


def _compact(new: torch.Tensor) -> torch.Tensor:
    """Stable in-shard compaction: kept (!= -1) elements keep their order
    and the holes sink to the shard's tail, so that array adjacency is
    pair adjacency in the next step.

    The reference sorts a payload on index keys (:67-83) because TPU
    scatters are slow.  Here a stable argsort of the one-byte hole mask
    (one radix pass) orders the gather: on the card it beat the
    reference's sort and a cumsum + scatter (``tools/compact_ab.py``,
    ``PERF.md`` section 6)."""
    return new.index_select(0, torch.argsort((new == -1).to(torch.uint8), stable=True))


def _top_k(values: torch.Tensor, k: int):
    """``lax.top_k`` of non-negative int32 ``values``: the k largest,
    and among equal values the lower index first.  ``torch.topk`` does
    not promise an order among ties (:255, :275), so each value carries
    its reversed index in the low 32 bits of an int64 key."""
    n = values.shape[0]
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=values.device)
    top = torch.topk((values.long() << 32) | rev, k).values
    return (top >> 32).to(values.dtype), (n - 1) - (top & 0xFFFFFFFF)


def _on(x, device):
    """A replicated tensor (or a Python int) on a shard's device."""
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _make_shard_ops(K: int, mesh: DataMesh, k_top: int = 1024) -> dict:
    """The per-shard count and merge ops of the bbpe trainer.

    Every op takes the list of shards.  Pads (-1) live only at each
    shard's tail (the compaction invariant), so the stream's pairs are
    the in-shard consecutive pairs plus one boundary pair per shard: its
    last valid element and the first element of the nearest non-empty
    successor shard (the reference's ``ppermute`` halo).
    """
    n_dev = mesh.size
    dev0 = mesh.devices[0]

    def _pair_operands(shards):
        """Per shard ``(a, b, lastvalid)``: ``b[i]`` is the stream
        successor of ``a[i]`` (-1 for none)."""
        if n_dev == 1:
            # no successor shard: past the last valid element b is a pad
            # already, so no halo is written (and ``lastvalid`` is unused)
            ids = shards[0]
            return [(ids, torch.cat([ids[1:], ids.new_full((1,), -1)]), None)]
        # shards can empty out late in training: the halo is the first
        # element of the NEAREST NON-EMPTY successor (:107-117)
        firsts = all_gather([ids[0] for ids in shards])
        shard_ids = torch.arange(n_dev, dtype=torch.int32, device=dev0)
        out = []
        for s, ids in zip(axis_index(mesh), shards):
            n = ids.shape[0]
            cand = torch.where((shard_ids > s) & (firsts >= 0), shard_ids, n_dev)
            nxt = cand.min()
            halo = torch.where(nxt < n_dev, _at(firsts, nxt.clamp(max=n_dev - 1)), -1)
            lastvalid = (ids >= 0).sum(dtype=torch.int32) - 1
            pos = torch.arange(n, dtype=torch.int32, device=ids.device)
            b = torch.cat([ids[1:], ids.new_full((1,), -1)])
            b = torch.where(pos == lastvalid, halo.to(ids.device), b)
            out.append((ids, b, lastvalid))
        return out

    def _sorted_segments(a, b):
        """The shard's pairs sorted by key, as runs of equal keys:
        ``(skey, sp, length, segstart, realend)``.  The sort is stable,
        so positions stay ascending inside a run and the run's last
        position ``sp`` is the pair's last occurrence in the shard."""
        valid = (a >= 0) & (b >= 0)
        key = torch.where(valid, (a.long() << ID_BITS) | b.long(), NO_PAIR)
        skey, sp = torch.sort(key, stable=True)
        idx = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
        diff = skey[1:] != skey[:-1]
        one = diff.new_ones(1)
        segstart = torch.cat([one, diff])
        length = idx - _last_true(segstart) + 1
        realend = torch.cat([diff, one]) & (skey != NO_PAIR)
        return skey, sp, length, segstart, realend

    def count_shard(shards):
        """Per shard, the dense ``K*K`` histogram and the last-occurrence
        position of each pair key, positions offset by shard so that
        ``pmax`` gives the global last occurrence.  ``_use_candidates``
        keeps ``a*K+b`` and ``shard*n+pos`` inside int32."""
        hists, occs = [], []
        for s, (a, b, _lv) in zip(axis_index(mesh), _pair_operands(shards)):
            n = a.shape[0]
            keys = a.long() * K + b.long()
            # the reference's mode="drop" (:137-143): pad pairs, and the
            # keys past the table that ids past the vocab give (a chunk's
            # steps after the vocab is full, which the host discards),
            # add 0 to key 0 and take the max with -1 there
            keep = (a >= 0) & (b >= 0) & (keys < K * K)
            keys = torch.where(keep, keys, 0)
            hist = torch.zeros(K * K, dtype=torch.int32, device=a.device)
            hist.scatter_add_(0, keys, keep.to(torch.int32))
            gpos = s * n + torch.arange(n, dtype=torch.int32, device=a.device)
            occ = torch.full((K * K,), -1, dtype=torch.int32, device=a.device)
            occ.scatter_reduce_(0, keys, torch.where(keep, gpos, -1), "amax")
            hists.append(hist)
            occs.append(occ)
        return hists, occs

    def pick_best(hist, occ):
        """(id1, id2, count): the max count, then the smallest last
        occurrence (argmin takes the first index at ties, as jnp does)."""
        m = hist.max()
        best = torch.argmin(torch.where(hist == m, occ, INF))
        return (best // K).to(torch.int32), (best % K).to(torch.int32), m

    def count_pick_sorted(shards):
        """Single-shard fused count + pick without the ``K*K`` tables:
        the same rule as ``pick_best`` over the sorted pair stream."""
        ((a, b, _lv),) = _pair_operands(shards)
        skey, sp, length, _segstart, realend = _sorted_segments(a, b)
        m = torch.where(realend, length, 0).max()
        # positions are distinct, so real candidates have one minimum
        j = torch.argmin(torch.where(realend & (length == m), sp, INF))
        key = _at(skey, j)
        return (key >> ID_BITS).to(torch.int32), (key & ID_MASK).to(torch.int32), m

    def count_candidates(shards):
        """Exact global ``(ga, gb, count, shard, lpos, bound)`` for the
        union of every shard's top-``k_top`` pairs.

        Exactness bound (Fagin-style): a pair outside every shard's top-k
        has at most that shard's k-th count t_s there, so its global
        count is at most ``bound = psum(t_s)``.  A winner above the bound
        is the true argmax; ``bound == 0`` means the candidates are
        complete.  Positions stay shard-local; the global last occurrence
        is the lexicographic (owning shard, local position) pair."""
        operands = _pair_operands(shards)
        n = shards[0].shape[0]
        k = min(k_top, n)
        if n_dev == 1:
            # the shard's own top-k is the candidate union, its counts
            # already exact: top-k straight off the sorted segment ends
            ((a, b, _lv),) = operands
            skey, sp, length, _segstart, realend = _sorted_segments(a, b)
            topv, topi = _top_k(torch.where(realend, length, 0), k)
            have = topv > 0
            gkey = torch.where(have, skey.index_select(0, topi), NO_PAIR)
            lpos = torch.where(have, sp.index_select(0, topi), -1).to(torch.int32)
            sh = torch.where(have, 0, -1).to(torch.int32)
            return (
                (gkey >> ID_BITS).to(torch.int32), (gkey & ID_MASK).to(torch.int32),
                topv, sh, lpos, topv[k - 1],
            )
        dkeys, dcnts, dlasts, tops = [], [], [], []
        for a, b, _lv in operands:
            skey, sp, length, segstart, realend = _sorted_segments(a, b)
            # the dense table of the shard's distinct pairs in key order,
            # NO_PAIR-padded: rows that end no real run go to slots past
            # n, one each (the reference's mode="drop" rows, :271-274)
            idx = torch.arange(n, dtype=torch.int64, device=a.device)
            rank = torch.cumsum(segstart, 0, dtype=torch.int64) - 1
            tgt = torch.where(realend, rank, n + idx)
            dkeys.append(skey.new_full((2 * n,), NO_PAIR).scatter_(0, tgt, skey)[:n])
            dcnts.append(length.new_zeros(2 * n).scatter_(0, tgt, length)[:n])
            dlasts.append(sp.new_full((2 * n,), -1).scatter_(0, tgt, sp)[:n])
            tops.append(_top_k(dcnts[-1], k))
        gkey = all_gather([d.index_select(0, topi) for d, (_v, topi) in zip(dkeys, tops)]).reshape(-1)
        cnts, shs, rows = [], [], []
        for s, dkey, dcnt in zip(axis_index(mesh), dkeys, dcnts):
            g = gkey.to(dkey.device)
            # lower bound of every candidate in the sorted table (the
            # reference's vectorised two-key binary search, :286-297)
            f = torch.searchsorted(dkey, g).clamp_(max=n - 1)
            hit = (dkey.index_select(0, f) == g) & (g != NO_PAIR)
            cnts.append(torch.where(hit, dcnt.index_select(0, f), 0))
            shs.append(torch.where(hit, s, -1).to(torch.int32))
            rows.append((hit, f))
        cnt, sh = psum(cnts), pmax(shs)
        lpos = pmax([
            torch.where(hit & (sh.to(hit.device) == s), dlast.index_select(0, f), -1).to(torch.int32)
            for s, (hit, f), dlast in zip(axis_index(mesh), rows, dlasts)
        ])
        bound = psum([topv[k - 1] for topv, _i in tops])
        return (
            (gkey >> ID_BITS).to(torch.int32), (gkey & ID_MASK).to(torch.int32),
            cnt, sh, lpos, bound,
        )

    def pick_candidates(ga, gb, cnt, sh, lpos, bound):
        """(id1, id2, count, ok): the bbpe rule over the candidates, the
        last occurrence compared as (shard, local position); ``ok``
        certifies the pick (the winner clears the bound, or the
        candidates are complete)."""
        m = cnt.max()
        is_m = cnt == m
        sh_min = torch.where(is_m, sh, INF).min()
        j = torch.argmin(torch.where(is_m & (sh == sh_min), lpos, INF))
        ok = (m > bound) | (bound == 0)
        return _at(ga, j), _at(gb, j), m, ok

    def apply_merge(shards, id1, id2, new_id):
        """Merge every left-to-right occurrence of (id1, id2) into
        ``new_id`` and compact each shard."""
        operands = _pair_operands(shards)
        matches = [
            (a == _on(id1, a.device)) & (b == _on(id2, a.device)) for a, b, _lv in operands
        ]
        return _apply_match(shards, matches, [lv for _a, _b, lv in operands], new_id)

    def _apply_match(shards, matches, lastvalids, new_id):
        if n_dev == 1:
            # no predecessor shard: the in-carry is 0
            ids, match = shards[0], matches[0]
            take = _merge_mask_device(match)
            consumed = torch.cat([take.new_zeros(1), take[:-1]])
            new = torch.where(take, _on(new_id, ids.device), ids)
            return [_compact(torch.where(consumed, -1, new))]
        # two take-chains per shard: in-carry 0 (element 0 alive) and 1
        # (element 0 consumed by the predecessor's boundary merge, which
        # flips the parity of a run crossing the boundary)
        chains, outs = [], []
        for ids, match, lastvalid in zip(shards, matches, lastvalids):
            n = ids.shape[0]
            take0 = _merge_mask_device(match)
            take1 = torch.cat([match.new_zeros(1), _merge_mask_device(match[1:])])
            last = lastvalid.clamp(0, n - 1)
            # an empty shard passes the consume-carry through unchanged
            # (:356-361)
            empty = lastvalid < 0
            outs.append(torch.stack([~empty & _at(take0, last), empty | _at(take1, last)]))
            chains.append((take0, take1))
        oo = all_gather(outs)  # [D, 2]
        carry = oo.new_zeros(())
        carries = [carry]
        for s in range(n_dev - 1):
            carry = torch.where(carry, oo[s, 1], oo[s, 0])
            carries.append(carry)
        out = []
        for s, ids, (take0, take1) in zip(axis_index(mesh), shards, chains):
            cin = carries[s].to(ids.device)
            take = torch.where(cin, take1, take0)
            consumed = torch.cat([cin.reshape(1), take[:-1]])
            new = torch.where(take, _on(new_id, ids.device), ids)
            out.append(_compact(torch.where(consumed, -1, new)))
        return out

    return {
        "count_shard": count_shard,
        "pick_best": pick_best,
        "count_pick_sorted": count_pick_sorted,
        "count_candidates": count_candidates,
        "pick_candidates": pick_candidates,
        "apply_merge": apply_merge,
    }


def make_train_step(
    K: int, mesh: DataMesh, min_merge_count: int = MIN_MERGE_COUNT,
    use_candidates: bool = False, k_top: int = 1024,
):
    """The single steps: ``(train_step, merge_step, fused_step)``.

    ``train_step(ids) -> (id1, id2, cnt, ok)`` picks by one sort on a
    1-shard mesh, by dense histograms + psum on small-K meshes and by the
    candidate union (``use_candidates``) past them; ``ok`` is constant
    True on the always-exact paths.  ``merge_step(ids, id1, id2, new_id)``
    applies a merge; ``fused_step(ids, new_id)`` picks and applies it
    when its count reaches ``min_merge_count`` and the pick is certified.
    The scalars are 0-d tensors on the mesh's first device, ``ids`` a
    list of shards; nothing here waits on the device.
    """
    ops = _make_shard_ops(K, mesh, k_top=k_top)
    certified = torch.ones((), dtype=torch.bool, device=mesh.devices[0])

    def train_step(ids):
        if mesh.size == 1:
            return (*ops["count_pick_sorted"](ids), certified)
        if use_candidates:
            return ops["pick_candidates"](*ops["count_candidates"](ids))
        hists, occs = ops["count_shard"](ids)
        return (*ops["pick_best"](psum(hists), pmax(occs)), certified)

    def fused_step(ids, new_id):
        id1, id2, cnt, ok = train_step(ids)
        merged = ops["apply_merge"](ids, id1, id2, new_id)
        # the merge must not land on a stop (count below the minimum) or
        # an uncertified pick: the state stays, so the caller's stop or
        # rollback is clean.  torch.where keeps it on the device (:574).
        land = (cnt >= min_merge_count) & ok
        new_ids = [torch.where(land.to(m.device), m, old) for m, old in zip(merged, ids)]
        return id1, id2, cnt, ok, new_ids

    return train_step, ops["apply_merge"], fused_step


def make_scan_train_step(
    K: int, mesh: DataMesh, min_merge_count: int, scan_steps: int,
    use_candidates: bool = False, k_top: int = 1024,
):
    """``scan_steps`` fused steps per chunk: ``(scan_step, fused_single,
    merge_single)``.

    ``scan_step(ids, start_new_id) -> (ids, stats)`` assigns ``new_id =
    start + i`` at step ``i`` (the common case) and returns the stacked
    ``(id1, id2, cnt, ok)`` as one int32 ``[4, scan_steps]`` tensor on
    the device, for one download per chunk.  The chunk makes no host
    sync.  The host replays the bookkeeping and falls back to single
    steps from the chunk's start when a duplicate-spelling merge makes
    the assumed ids wrong, or at the first uncertified pick.
    """
    _pick, merge_single, fused_single = make_train_step(
        K, mesh, min_merge_count, use_candidates=use_candidates, k_top=k_top
    )

    def scan_step(ids, start_new_id):
        rows = []
        for i in range(scan_steps):
            id1, id2, cnt, ok, ids = fused_single(ids, start_new_id + i)
            rows.append(torch.stack([id1, id2, cnt, ok.to(torch.int32)]))
        return ids, torch.stack(rows, 1)

    return scan_step, fused_single, merge_single


def _fetch_global(ids: list[torch.Tensor]) -> np.ndarray:
    """The sharded array on the host, shard after shard."""
    return np.concatenate([s.cpu().numpy() for s in ids])


def _global_stream(ids_np: np.ndarray) -> np.ndarray:
    """Flatten shard-major and drop -1 pads: tail pads vanish and the
    shard streams concatenate into the exact global element stream."""
    stream = ids_np.reshape(-1)
    return stream[stream != -1]


def _pair_keys(stream: np.ndarray) -> np.ndarray:
    """Packed int64 adjacent-pair keys (ids are < 2^31, nonneg)."""
    a = stream[:-1].astype(np.int64)
    b = stream[1:].astype(np.int64)
    return (a << np.int64(31)) | b


def _host_exact_pick(ids_np: np.ndarray):
    """Exact global (id1, id2, count) bbpe pick on the host.

    The always-correct fallback when the candidate bound cannot certify
    a device pick (rare: very flat pair distributions mid-training).
    """
    from ..train.common import count_pairs, first_to_reach_winner

    stream = _global_stream(ids_np)
    if stream.shape[0] < 2:
        return None
    uniq, inverse, counts = count_pairs(_pair_keys(stream))
    win, maxc = first_to_reach_winner(inverse, counts)
    key = int(uniq[win])
    return key >> 31, key & ((1 << 31) - 1), int(maxc)


def _use_candidates(K: int, n_dev: int, n_total: int = 0) -> bool:
    """Dense K^2 histograms only for small vocabs on multi-device meshes;
    the candidate machinery covers GPT-2 scale and beyond."""
    if n_dev <= 1:
        return False
    if K * K >= 2**31:
        # the dense path's a*K+b int32 keys would overflow — candidates
        # are mandatory regardless of any env override
        return True
    if n_total >= 2**31:
        # the dense path's shard_idx*n+pos occ packing would overflow
        return True
    if os.environ.get("HUTOKEN_TPU_TRAIN_FORCE_CANDIDATES") == "1":
        return True
    dense_kmax = int(os.environ.get("HUTOKEN_TPU_TRAIN_DENSE_KMAX", "4096"))
    return K > dense_kmax


def distributed_bbpe_train(
    data: bytes,
    vocab_size: int,
    *,
    mesh: DataMesh,
    verbose: bool = True,
    scan_steps: int = 32,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 512,
    resume: bool = False,
) -> dict[bytes, int]:
    """Byte-level training on the mesh's devices (``data_mesh()``: the
    card), ``scan_steps`` merges per chunk, optional checkpoint/resume;
    returns the vocab ``bbpe_train_core`` returns.

    Scanned device steps + host bookkeeping replay (the bbpe branch of
    the reference's driver, :1735-1914): new ids are ``count`` (no +1,
    src/bbpe.c:87), training stops at a count below 2 and when the same
    id pair wins twice in a row."""
    if not isinstance(mesh, DataMesh):
        raise TypeError(
            f"mesh must be a hutoken_tpu_torch.parallel.DataMesh (data_mesh()), "
            f"not {type(mesh).__name__}"
        )
    K = vocab_size + 1
    n_dev = mesh.size
    use_candidates = _use_candidates(K, n_dev, n_total=len(data))
    str2id: dict[bytes, int] = {}
    id2str: dict[int, bytes] = {}
    for i in range(256):
        key = b"" if i == 0 else bytes([i])
        str2id[key] = i
        id2str[i] = key
    count = 256

    ids_np = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
    if ids_np.shape[0] == 0:
        ids_np = np.full(1, -1, np.int32)  # every shard holds one element
    scan_step, fused_single, merge_single = make_scan_train_step(
        K, mesh, MIN_MERGE_COUNT, scan_steps, use_candidates=use_candidates
    )
    ids = shard_batch(mesh, ids_np)

    # resume: reload the checkpoint vocab + merge log, replay the merges
    # onto the sharded corpus, and continue training from there
    merge_log: list[tuple[int, int, int]] = []
    if resume and checkpoint_path is not None and os.path.exists(
        checkpoint_path + ".merges"
    ):
        from ..train.common import load_checkpoint

        str2id = load_checkpoint(checkpoint_path)
        id2str = {idx: tok for tok, idx in str2id.items()}
        count = len(str2id)  # hashmap-count semantics: distinct keys
        with open(checkpoint_path + ".merges", encoding="utf-8") as f:
            for line in f:
                id1, id2, new_id = (int(x) for x in line.split())
                merge_log.append((id1, id2, new_id))
                ids = merge_single(ids, id1, id2, new_id)
        if verbose:
            print(f"resumed {len(merge_log)} merges from {checkpoint_path}")

    def checkpoint() -> None:
        if checkpoint_path is None:
            return
        from ..train.common import save_checkpoint

        save_checkpoint(str2id, checkpoint_path)
        with open(checkpoint_path + ".merges.tmp", "w", encoding="utf-8") as f:
            for id1, id2, new_id in merge_log:
                f.write(f"{id1} {id2} {new_id}\n")
        os.replace(checkpoint_path + ".merges.tmp", checkpoint_path + ".merges")

    merges_since_ckpt = 0
    prev_stop_key = None

    def bookkeep(id1: int, id2: int, cnt: int, expected_id: int):
        """Returns (replacement, stop_key)."""
        nonlocal count, merges_since_ckpt
        merge_log.append((id1, id2, expected_id))
        merges_since_ckpt += 1
        if merges_since_ckpt >= checkpoint_every:
            merges_since_ckpt = 0
            checkpoint()
        merged = id2str.get(id1, b"") + id2str.get(id2, b"")
        replacement = merged in str2id
        if not replacement:
            count += 1
        str2id[merged] = expected_id
        id2str[expected_id] = merged
        if verbose:
            print(f"Most common pair: ({id1}, {id2}), freq: {cnt}")
            print(f"New token id: {expected_id}\n")
        return replacement, (id1, id2)

    while count < vocab_size:
        chunk_start_ids = ids
        chunk_start_count = count
        chunk_start_log = len(merge_log)
        chunk_added: list[bytes] = []
        start_id = count
        new_ids, stats = scan_step(ids, start_id)
        id1s, id2s, cnts, oks = stats.cpu().numpy()  # the chunk's one download

        stopped = False
        diverged_at = -1
        for i in range(scan_steps):
            if not oks[i]:
                # the candidate bound could not certify this pick — the
                # step (and everything after it) is untrusted; redo it
                # single-step with the exact fallback
                diverged_at = i
                break
            cnt = int(cnts[i])
            if cnt < MIN_MERGE_COUNT:
                stopped = True
                break
            expected_id = count
            if expected_id != start_id + i:
                # a duplicate-spelling merge desynced device id assignment
                diverged_at = i
                break
            replacement, stop_key = bookkeep(
                int(id1s[i]), int(id2s[i]), cnt, expected_id
            )
            if not replacement:
                chunk_added.append(id2str[expected_id])
            if prev_stop_key is not None and stop_key == prev_stop_key:
                stopped = True
                break
            prev_stop_key = stop_key
            if count >= vocab_size:
                stopped = True
                break
        if stopped:
            break
        if diverged_at >= 0:
            # rollback this chunk's bookkeeping and redo it single-step
            for added in chunk_added:
                del str2id[added]
            del merge_log[chunk_start_log:]
            # (ids overwritten below; id2str stale entries are harmless)
            count = chunk_start_count
            prev_stop_key = None  # conservatively recomputed below
            ids = chunk_start_ids
            done = False
            # single-step up to AND past the divergence point, then
            # resume scanning: stopping short of the duplicate would
            # make the next scan re-diverge at the same step and waste
            # a full chunk per cycle; finishing the whole chunk
            # single-step wastes ~15x the other way
            for _ in range(min(diverged_at + 2, scan_steps)):
                if count >= vocab_size:
                    done = True
                    break
                new_id = count
                s_id1, s_id2, cnt, s_ok, stepped = fused_single(ids, new_id)
                if not bool(s_ok):
                    # uncertifiable even single-step: exact host pick
                    # (numpy over the downloaded stream), then the
                    # device applies the merge as usual
                    picked = _host_exact_pick(_fetch_global(ids))
                    if picked is None:
                        done = True
                        break
                    s_id1, s_id2, cnt = picked
                    if cnt >= MIN_MERGE_COUNT:
                        stepped = merge_single(ids, s_id1, s_id2, new_id)
                cnt = int(cnt)
                if cnt < MIN_MERGE_COUNT:
                    done = True
                    break
                ids = stepped
                replacement, stop_key = bookkeep(
                    int(s_id1), int(s_id2), cnt, new_id
                )
                if prev_stop_key is not None and stop_key == prev_stop_key:
                    done = True
                    break
                prev_stop_key = stop_key
            if done:
                break
            continue
        # drop the pad tail all shards share: it holds no pair, and every
        # op's work then follows the live length (the results do not
        # change; the last valid element's position in a shard does not)
        live = int(pmax([(s >= 0).sum() for s in new_ids]))
        ids = [s[: max(live, 1)] for s in new_ids]
    checkpoint()
    return str2id


def distributed_bpe_train(
    data: bytes,
    vocab_size: int,
    *,
    mesh,
    verbose: bool = True,
    scan_steps: int = 32,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 512,
    resume: bool = False,
) -> dict[bytes, int]:
    """String-keyed (spelling-group) training: not ported yet, raises."""
    raise NotImplementedError(MESH_MSG)

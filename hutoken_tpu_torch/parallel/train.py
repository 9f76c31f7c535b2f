"""Device BPE training on the data mesh.

The port of ``hutoken_tpu/parallel/train.py``'s two trainers (reference:
src/bbpe.c:73-124, src/bpe.c:108-231).  The corpus lives sharded over
the mesh as int32 id arrays (-1 pads only at each shard's tail); each
merge step

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
writes, and ``distributed_bpe_train`` what ``bpe_train_core(strict=False)``
writes (``tests/test_torch_train.py``, ``tests/test_torch_train_string.py``).
``make_scan_train_step`` enqueues ``scan_steps`` merges on the device
without a host sync and downloads their stacked results once; the host
replays the bookkeeping.

The byte-level (bbpe) trainer is id-keyed; the string (bpe) trainer is
SPELLING-GROUP-keyed like the reference (all compositions of the winning
spelling count and merge together) and runs a host-paced loop over
speculative scan chunks, a deep candidate table and targeted probes:
see ``_distributed_train_string``.

Each op is written as per-shard phases with the collectives between
them, where ``shard_map`` hides those boundaries in the reference.  On a
mesh that spans processes (``multihost.global_data_mesh``) each process
holds its own shards of the corpus, which every process passes whole,
the collectives cross processes, and every process runs the same host
driver on the same replicated results; the host merge of a spelling
past ``MAXC`` compositions is single-process only, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .collectives import all_gather, all_gather_ragged, axis_index, pmax, psum
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
# the string trainer: the most compositions (splits of the winning
# spelling into two live spellings) merged on the device in one step,
# the query width of ``probe_pairs``, and the deep candidate table's k
MAXC = 64
PROBE_P = 64
DEEP_K = 32768
# ``probe_pairs`` sends the stream positions that match no query to
# slots of their own past the P query slots, spread over this many, so
# that no slot takes more than n / MISS_SLOTS atomic adds
MISS_SLOTS = 1024
# the string trainer's spelling hash: H(s) = sum (s[i] + 1) * P^i mod 2^64,
# so that H(ab) = H(a) + P^len(a) * H(b) groups pairs by their spelling
SPELL_HASH_P = np.uint64(1099511628211)


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
    """The per-shard count, merge and probe ops of both trainers.

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
        firsts = all_gather([ids[0] for ids in shards], mesh)
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
        gkey = all_gather([d.index_select(0, topi) for d, (_v, topi) in zip(dkeys, tops)], mesh).reshape(-1)
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
        cnt, sh = psum(cnts, mesh), pmax(shs, mesh)
        lpos = pmax([
            torch.where(hit & (sh.to(hit.device) == s), dlast.index_select(0, f), -1).to(torch.int32)
            for s, (hit, f), dlast in zip(axis_index(mesh), rows, dlasts)
        ], mesh)
        bound = psum([topv[k - 1] for topv, _i in tops], mesh)
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

    def _pair_keys(a, b, valid):
        """The stream's pair keys ``(a << 31) | b``, -1 where not
        ``valid``: no query key is negative, so those match nothing."""
        return torch.where(valid, (a.long() << ID_BITS) | (b.long() & ID_MASK), -1)

    def _lookup(sorted_keys, keys):
        """(slot, hit): each key's lower bound in ``sorted_keys`` and
        whether the key is there."""
        f = torch.searchsorted(sorted_keys, keys).clamp_(max=sorted_keys.shape[0] - 1)
        return f, sorted_keys.index_select(0, f) == keys

    def apply_merge_multi(shards, c1, c2, new_id):
        """Merge every composition ``(c1[j], c2[j])`` of one winning
        spelling in one left-to-right pass: the string trainer's
        semantics (src/bpe.c:181-215 compares the pair's concatenated
        SPELLING to the winner, so all compositions merge together).
        ``c1``/``c2`` are int32 ``[MAXC]``, -1-padded.

        The reference compares every position with every composition
        (``[MAXC, n]`` broadcasts, :331-344); here each position's pair
        key is looked up in the sorted composition keys.  As there, a
        position matches where ``a == c1[j]``, ``b == c2[j]`` and
        ``c1[j] >= 0``; ``b & ID_MASK`` makes a missing successor (-1)
        meet a composition whose ``c2`` is -1."""
        operands = _pair_operands(shards)
        c1, c2 = c1.long(), c2.long()
        comps = torch.sort(torch.where(c1 >= 0, (c1 << ID_BITS) | (c2 & ID_MASK), NO_PAIR)).values
        matches = [
            _lookup(comps.to(a.device), _pair_keys(a, b, a >= 0))[1] for a, b, _lv in operands
        ]
        return _apply_match(shards, matches, [lv for _a, _b, lv in operands], new_id)

    def probe_pairs(shards, qa, qb):
        """Exact global ``(count, last shard, last local position)`` of
        the query pairs ``(qa[j], qb[j])`` (-1 pads count 0, with shard
        and position -1): the resolver for near-tie certification
        failures (:377-399), with ``qa``/``qb`` int32 ``[PROBE_P]``.

        In place of the reference's ``[P, n]`` compares, each stream
        pair's key is looked up in the sorted query keys; a scatter-add
        counts the hits per query and a scatter-max takes their last
        position.  Equal queries read the same slot, so they get equal
        rows."""
        qa, qb = qa.long(), qb.long()
        qkey = torch.where((qa >= 0) & (qb >= 0), (qa << ID_BITS) | qb, NO_PAIR)
        sq = torch.sort(qkey).values
        first = torch.searchsorted(sq, qkey)  # a query's row: its key's first slot
        p = qkey.shape[0]
        cnts, lasts = [], []
        for a, b, _lv in _pair_operands(shards):
            pos = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
            f, hit = _lookup(sq.to(a.device), _pair_keys(a, b, (a >= 0) & (b >= 0)))
            slot = torch.where(hit, f, p + (pos.long() & (MISS_SLOTS - 1)))
            cnt = torch.zeros(p + MISS_SLOTS, dtype=torch.int32, device=a.device)
            cnt.scatter_add_(0, slot, hit.to(torch.int32))
            last = torch.full((p + MISS_SLOTS,), -1, dtype=torch.int32, device=a.device)
            last.scatter_reduce_(0, slot, torch.where(hit, pos, -1), "amax")
            row = first.to(a.device)
            cnts.append(cnt.index_select(0, row))
            lasts.append(last.index_select(0, row))
        cnt = psum(cnts, mesh)
        sh = pmax([torch.where(last >= 0, s, -1).to(torch.int32) for s, last in zip(axis_index(mesh), lasts)], mesh)
        lp = pmax([
            torch.where((last >= 0) & (sh.to(last.device) == s), last, -1)
            for s, last in zip(axis_index(mesh), lasts)
        ], mesh)
        return cnt, sh, lp

    def group_pick(shards, gh, gp):
        """The exact spelling-group winner on the device: ``(count, last,
        pair keys of the winning group)``, None when no pair is left.

        A pair ``(a, b)`` spells csid ``a``'s spelling and then ``b``'s;
        it groups by that string's rolling hash ``H(a) + P^len(a) * H(b)``
        mod 2^64, from ``gh[c] = H(c)`` and ``gp[c] = P^len(c)`` (int64,
        which wraps as uint64 does).  Each shard sorts its pairs' hashes
        and reduces the runs to (count, last (shard, position)); runs of
        one hash from several shards add their counts and keep the max
        last.  The winner is the max count, then the min last: the host
        trainer's rule.  Equal spellings hash alike, so a group holds
        every pair of its spelling; a collision can only join groups,
        which the caller sees in the winner's pairs.  Host-paced: it
        syncs, as the exact pick it replaces downloads the stream."""
        keys, cnts, lasts, hashed = [], [], [], []
        for s, (a, b, _lv) in zip(axis_index(mesh), _pair_operands(shards)):
            valid = (a >= 0) & (b >= 0)
            if not bool(valid.any()):
                none = a.new_zeros(0, dtype=torch.int64)
                for out in (keys, cnts, lasts):
                    out.append(none)
                hashed.append((none, none))
                continue
            pos = torch.arange(a.shape[0], device=a.device)[valid]
            a, b = a[valid].long(), b[valid].long()
            h, p = gh.to(a.device), gp.to(a.device)
            g = h.index_select(0, a) + p.index_select(0, a) * h.index_select(0, b)
            sk, order = torch.sort(g, stable=True)
            ends = torch.nonzero(torch.cat([sk[1:] != sk[:-1], valid.new_ones(1)]))[:, 0]
            keys.append(sk.index_select(0, ends))
            cnts.append(torch.diff(ends, prepend=ends.new_full((1,), -1)))
            lasts.append((s << 32) | pos.index_select(0, order).index_select(0, ends))
            hashed.append((g, (a << ID_BITS) | b))
        # the runs of every shard, ragged, on the first local device
        key = all_gather_ragged(keys, mesh)
        if key.shape[0] == 0:
            return None
        cnt = all_gather_ragged(cnts, mesh)
        last = all_gather_ragged(lasts, mesh)
        if n_dev > 1:
            key, order = torch.sort(key, stable=True)
            first = torch.cat([key.new_ones(1, dtype=torch.bool), key[1:] != key[:-1]])
            seg = torch.cumsum(first, 0) - 1
            total = cnt.new_zeros(int(seg[-1]) + 1)
            cnt = total.scatter_add_(0, seg, cnt.index_select(0, order))
            last = torch.full_like(cnt, -1).scatter_reduce_(0, seg, last.index_select(0, order), "amax")
            key = key[first]
        m = cnt.max()
        j = torch.argmin(torch.where(cnt == m, last, torch.iinfo(torch.int64).max))
        wkey = key[j]
        pairs = torch.unique(all_gather_ragged([pk[g == wkey.to(g.device)] for g, pk in hashed], mesh))
        return int(m), int(last[j]), pairs.cpu().numpy()

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
        oo = all_gather(outs, mesh)  # [D, 2]
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
        "apply_merge_multi": apply_merge_multi,
        "probe_pairs": probe_pairs,
        "group_pick": group_pick,
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
        return (*ops["pick_best"](psum(hists, mesh), pmax(occs, mesh)), certified)

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


def _packed(*parts) -> torch.Tensor:
    """The parts, flattened into one int32 tensor: one download."""
    return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])


def make_string_step(mesh: DataMesh, k_top: int = 1024):
    """The string trainer's single steps: ``(string_step,
    merge_multi_step, probe_step)``.

    ``string_step(ids, c1, c2, new_id) -> (ids, packed)`` applies the
    PREVIOUS winner's compositions (a no-op when ``c1`` is all -1) and
    counts candidates for the next pick, their stats packed as one int32
    tensor ``[ga, gb, cnt, sh, lpos, bound]`` for one download a merge.
    ``merge_multi_step(ids, c1, c2, new_id)`` applies compositions alone
    (rollback replay, checkpoint replay); ``probe_step(ids, qa, qb) ->
    (cnt, sh, lp)`` counts query pairs.  ``c1``/``c2``/``qa``/``qb`` are
    int32 tensors on the mesh's first device; nothing here waits on the
    device."""
    ops = _make_shard_ops(2, mesh, k_top=k_top)  # K unused by these ops

    def string_step(ids, c1, c2, new_id):
        ids = ops["apply_merge_multi"](ids, c1, c2, new_id)
        return ids, _packed(*ops["count_candidates"](ids))

    return string_step, ops["apply_merge_multi"], ops["probe_pairs"]


# scan-driver telemetry (tests, the smoke): chunks dispatched, fully
# committed chunks, divergent sub-steps (rollback + exact re-run), and
# the picks that settled an uncertified step: by a probe, by the deep
# table, by the exact pick
STRING_SCAN_STATS = {"chunks": 0, "committed": 0, "divergent": 0,
                     "exact_picks": 0, "probe_picks": 0, "deep_picks": 0}


def make_string_scan_step(mesh: DataMesh, S: int, k_top: int = 1024):
    """S-merge SPECULATIVE chunks for the string trainer.

    ``scan_fn(ids, start_csid, qa, qb) -> (ids, rows)``: each of the S
    sub-steps counts candidates, applies the plain PAIR pick (max count,
    min last occurrence) with csid ``start + i``, probes the watch-list
    ``(qa, qb)`` and emits one int32 row ``[ga, gb, cnt, sh, lpos, wc,
    wsh, wlp, bound, id1, id2, c]``; ``rows`` stacks them, ``[S, ...]``,
    for one download a chunk.  The chunk makes no host sync: the pick
    and the conditional merge stay tensors.  The host then validates
    every sub-step against the spelling-group semantics and rolls back
    at the first one that diverges (``_distributed_train_string``)."""
    ops = _make_shard_ops(2, mesh, k_top=k_top)

    def scan_fn(ids, start_csid, qa, qb):
        rows = []
        for i in range(S):
            ga, gb, cnt, sh, lpos, bound = ops["count_candidates"](ids)
            id1, id2, c, _ok = ops["pick_candidates"](ga, gb, cnt, sh, lpos, bound)
            # watch-list: exact per-sub-step counts of the pairs the host
            # flagged as recurring near-tie contenders, so that their
            # certification resolves inline and the chunk commits
            wc, wsh, wlp = ops["probe_pairs"](ids, qa, qb)
            merged = ops["apply_merge"](ids, id1, id2, start_csid + i)
            land = c > 0
            ids = [torch.where(land.to(m.device), m, old) for m, old in zip(merged, ids)]
            rows.append(_packed(ga, gb, cnt, sh, lpos, wc, wsh, wlp, torch.stack([bound, id1, id2, c])))
        return ids, torch.stack(rows)

    return scan_fn


def _fetch_global(ids: list[torch.Tensor], mesh: DataMesh) -> np.ndarray:
    """The sharded array on the host, shard after shard: gathered from
    every process when the mesh spans processes (the reference's
    ``process_allgather``, :1631-1641)."""
    if mesh.process_count > 1:
        return all_gather(ids, mesh).cpu().numpy().reshape(-1)
    return np.concatenate([s.cpu().numpy() for s in ids])


def _write_checkpoint(str2id: dict, path: str, mesh: DataMesh, log_lines) -> None:
    """The vocab snapshot at ``path`` and the merge log at ``path +
    ".merges"``, each replaced atomically.  Every process writes both,
    as the reference's do; on a mesh that spans processes each first
    writes files of its own, so that processes sharing a file system
    never replace one another's half-written file."""
    from ..train.common import save_checkpoint

    own = f".p{mesh.process_index}" if mesh.process_count > 1 else ""
    save_checkpoint(str2id, path + own)
    if own:
        os.replace(path + own, path)
    with open(path + ".merges.tmp" + own, "w", encoding="utf-8") as f:
        f.writelines(log_lines)
    os.replace(path + ".merges.tmp" + own, path + ".merges")


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
        if checkpoint_path is not None:
            _write_checkpoint(str2id, checkpoint_path, mesh,
                              (f"{id1} {id2} {new_id}\n" for id1, id2, new_id in merge_log))

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
                    picked = _host_exact_pick(_fetch_global(ids, mesh))
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
        live = int(pmax([(s >= 0).sum() for s in new_ids], mesh))
        ids = [s[: max(live, 1)] for s in new_ids]
    checkpoint()
    return str2id


def _group_stats(pair_stats: dict, csid2spell: list):
    """Aggregate exact per-pair stats into per-spelling groups.

    A group's count is the sum over its compositions; its last
    occurrence is the max (the group reaches its final count at its
    last occurrence, so the first-to-reach tie-break is min group-last
    — same equivalence as for pairs)."""
    groups: dict[bytes, list] = {}
    for (a, b), (c, last) in pair_stats.items():
        s = csid2spell[a] + csid2spell[b]
        g = groups.get(s)
        if g is None:
            groups[s] = [c, last]
        else:
            g[0] += c
            g[1] = max(g[1], last)
    return groups


def _pick_group(groups: dict):
    """(spelling, [count, last]) winner: max count, tie-break min last
    occurrence.  ``last`` may be an int or a lexicographic (shard,
    position) tuple — both order correctly."""
    max_c = max(g[0] for g in groups.values())
    return min(
        ((s, g) for s, g in groups.items() if g[0] == max_c),
        key=lambda kv: kv[1][1],
    )


def _host_exact_string_pick(ids_np: np.ndarray, csid2spell: list):
    """Exact global spelling-group pick on the host (fallback when the
    candidate bound cannot certify)."""
    stream = _global_stream(ids_np)
    if stream.shape[0] < 2:
        return None
    keys = _pair_keys(stream)
    uniq, inverse, counts = np.unique(
        keys, return_inverse=True, return_counts=True
    )
    last_occ = np.empty(uniq.shape[0], dtype=np.int64)
    last_occ[inverse] = np.arange(keys.shape[0], dtype=np.int64)
    pair_stats = {
        (int(k) >> 31, int(k) & ((1 << 31) - 1)): (int(c), int(l))
        for k, c, l in zip(uniq, counts, last_occ)
    }
    groups = _group_stats(pair_stats, csid2spell)
    return _pick_group(groups)


def _host_apply_multi(
    ids_np: np.ndarray, comps: list, new_csid: int, n_dev: int
) -> np.ndarray:
    """Host-side multi-composition merge + reshard (only for winners
    with more than MAXC compositions — pathological)."""
    from ..train.common import left_to_right_merge_mask

    stream = _global_stream(ids_np)
    keys = _pair_keys(stream)
    ckeys = np.array(
        [(c1 << 31) | c2 for c1, c2 in comps], dtype=np.int64
    )
    match = np.isin(keys, ckeys)
    take = left_to_right_merge_mask(match)
    take_idx = np.flatnonzero(take)
    consumed = np.zeros(stream.shape[0], dtype=bool)
    consumed[take_idx + 1] = True
    new = stream.copy()
    new[take_idx] = new_csid
    kept = new[~consumed]
    # reshard: contiguous chunks in shard order, pads at shard tails
    n = ids_np.reshape(-1).shape[0] // n_dev
    per = -(-kept.shape[0] // n_dev)
    out = np.full((n_dev, n), -1, dtype=np.int32)
    for s in range(n_dev):
        chunk = kept[s * per : (s + 1) * per]
        out[s, : chunk.shape[0]] = chunk
    return out.reshape(-1)


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a host sync: a copy from
    pageable memory is staged before the call returns, so ``array`` may
    go at once."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device, non_blocking=True)


def _distributed_train_string(
    data: bytes,
    vocab_size: int,
    mesh: DataMesh,
    *,
    verbose: bool,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 512,
    resume: bool = False,
    k_top: int = 1024,
) -> dict[bytes, int]:
    """Spelling-group-keyed distributed string training (the reference's
    :804-1627).

    Parity target: ``bpe_train_core(strict=False)`` (src/bpe.c semantics
    — the merge loop compares the pair's concatenated SPELLING against
    the winner, so every composition of the winning spelling counts and
    merges together, src/bpe.c:130-165, 181-215).

    Device elements are canonical spelling ids (csids, one per distinct
    spelling — the array analog of the host trainer's interning), which
    keeps "two live elements, same spelling, different ids" impossible
    even across duplicate-spelling re-wins.  Each merge step:

    1. device candidate stats (exact counts of the per-shard top-k
       union + the Fagin bound, see count_candidates),
    2. HOST aggregation of pairs into spelling groups + safety check:
       the winner must beat every other candidate group's upper bound
       (count + #uncounted-compositions x bound) and the unseen-group
       bound ``_nlen() * bound``; otherwise a probe of the uncounted
       compositions, the deep table or the exact pick settles it,
    3. device multi-composition merge (one left-to-right pass over all
       splits of the winning spelling, matching the host's single
       group mask).

    Vocab ids replay the reference quirks exactly: new id = count+1
    (id 256 never assigned, duplicate-spelling re-wins can alias ids —
    src/bpe.c:171); repeat-stop compares winning spellings.

    The exact pick runs on the device (``group_pick``: pairs grouped by
    the rolling hash of their spelling, the winner's pairs checked by
    real concatenation), where the reference downloads the stream and
    aggregates every pair in Python (``_host_exact_string_pick``, kept
    for a hash collision): at 4 M ids the deep table cannot certify most
    tail merges, and the host pick took 0.5 s each.

    Unlike the reference, the deep pick drops the duplicate ``(a, b)``
    rows of its candidate table before it sums pairs into groups: on a
    mesh of D > 1 shards the union lists a pair once per shard whose
    top-k holds it, each row with the same global count, and the
    reference's ``np.add.at`` counts it that many times
    (``tests/test_torch_train_string.py`` keeps the witness).
    """
    dev0 = mesh.devices[0]
    n_dev = mesh.size
    # the Fagin bound is nlen * B with B = the k-th-largest per-shard
    # pair count; nlen grows with training, so a small k leaves B ~70-80
    # on MB-scale corpora and certification fails chronically past ~100
    # merges.  A deeper candidate table pushes B into the count tail;
    # the extra candidate rows only cost download + host-dict size.
    kv = os.environ.get("HUTOKEN_TPU_STRING_KTOP", "8192")
    try:
        k_top = max(int(kv), k_top)
    except ValueError:
        pass
    string_step, merge_multi_step, probe_step = make_string_step(
        mesh, k_top=k_top
    )

    # vocab bookkeeping (the returned artifact, with reference quirks)
    str2id: dict[bytes, int] = {}
    for i in range(256):
        str2id[b"" if i == 0 else bytes([i])] = i
    count = 256
    # csid interning: device element id -> spelling (csid 0 spells
    # b"\\x00" — the vocab's b"" key is a save-format quirk only)
    csid2spell: list[bytes] = [bytes([i]) for i in range(256)]
    # rolling-hash + length per csid (numpy-indexable), for the deep
    # pick's vectorized group aggregation: H(ab) = H(a) + P^len(a)*H(b)
    # mod 2^64.  Hash equality is VERIFIED by real concat on the few
    # groups that matter before any decision rides on it.
    _HP = SPELL_HASH_P
    _pows = [np.uint64(1)]

    def _pow_hp(k: int) -> np.uint64:
        with np.errstate(over="ignore"):  # mod-2^64 wrap is the point
            while len(_pows) <= k:
                _pows.append(_pows[-1] * _HP)
        return _pows[k]

    def _hash_bytes(b: bytes) -> np.uint64:
        h = np.uint64(0)
        with np.errstate(over="ignore"):
            for i, c in enumerate(b):
                h = h + _pow_hp(i) * np.uint64(c + 1)
        return h

    _sh_cap = 4096
    spell_h = np.zeros(_sh_cap, np.uint64)
    spell_l = np.zeros(_sh_cap, np.int64)
    for _i in range(256):
        spell_h[_i] = _hash_bytes(csid2spell[_i])
        spell_l[_i] = len(csid2spell[_i])
    _sh_state = {"n": 256, "h": spell_h, "l": spell_l}

    def _note_csid(s_: bytes) -> None:
        st = _sh_state
        if st["n"] == st["h"].shape[0]:
            st["h"] = np.concatenate([st["h"], np.zeros_like(st["h"])])
            st["l"] = np.concatenate([st["l"], np.zeros_like(st["l"])])
        st["h"][st["n"]] = _hash_bytes(s_)
        st["l"][st["n"]] = len(s_)
        st["n"] += 1
    spell2csid: dict[bytes, int] = {s: i for i, s in enumerate(csid2spell)}

    ids_np = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
    if ids_np.shape[0] == 0:
        ids_np = np.full(1, -1, np.int32)  # every shard holds one element
    ids = shard_batch(mesh, ids_np)
    # trimming the shared pad tail (after each committed chunk) stops at
    # the deep table's k: every count_candidates then takes the k it
    # takes on the untrimmed shard, min(k_top, n), and with it the same
    # candidates and bound
    trim_floor = min(DEEP_K, ids[0].shape[0])

    hi = 0x7FFFFFFF
    merge_log: list[bytes] = []
    prev_key: bytes | None = None
    merges_since_ckpt = 0

    def comps_of(s: bytes) -> list[tuple[int, int]]:
        out = []
        for i in range(1, len(s)):
            u = spell2csid.get(s[:i])
            v = spell2csid.get(s[i:])
            if u is not None and v is not None:
                out.append((u, v))
        return out

    def intern_winner(win_s: bytes):
        """csid assignment; returns (csid, composition list)."""
        g = spell2csid.get(win_s)
        if g is None:
            g = len(csid2spell)
            csid2spell.append(win_s)
            spell2csid[win_s] = g
            _note_csid(win_s)
        return g, comps_of(win_s)

    def comp_arrays(comps):
        c1 = np.full(MAXC, -1, np.int32)
        c2 = np.full(MAXC, -1, np.int32)
        for j, (u, v) in enumerate(comps):
            c1[j] = u
            c2[j] = v
        return c1, c2

    def merge_multi(ids_now, c1, c2, g):
        """``merge_multi_step`` on host composition arrays (one upload)."""
        c = _upload(np.stack([c1, c2]), dev0)
        return merge_multi_step(ids_now, c[0], c[1], g)

    def host_merge(comps, g):
        # a winning spelling with > MAXC compositions: merged on the
        # host and resharded
        nonlocal ids
        if mesh.process_count > 1:
            raise NotImplementedError(
                "a winning spelling with more than MAXC compositions "
                "requires the host merge path, which is single-process "
                "only"
            )
        new_np = _host_apply_multi(_fetch_global(ids, mesh), comps, g, n_dev)
        ids = shard_batch(mesh, new_np)

    def apply_winner(win_s: bytes):
        """Immediate csid assignment + merge (checkpoint replay)."""
        nonlocal ids
        g, comps = intern_winner(win_s)
        if len(comps) <= MAXC:
            ids = merge_multi(ids, *comp_arrays(comps), g)
        else:
            host_merge(comps, g)
        return g

    def checkpoint() -> None:
        if checkpoint_path is not None:
            _write_checkpoint(str2id, checkpoint_path, mesh,
                              ("s " + s.hex() + "\n" for s in merge_log))

    def bookkeep(win_s: bytes, win_c: int, replay: bool = False) -> None:
        """``replay=True`` during resume: no checkpoint writes (a
        mid-replay checkpoint would truncate the on-disk .merges log to
        the replayed prefix, destroying durable progress) and no
        progress prints."""
        nonlocal count, merges_since_ckpt
        merge_log.append(win_s)
        if not replay:
            merges_since_ckpt += 1
            if merges_since_ckpt >= checkpoint_every:
                merges_since_ckpt = 0
                checkpoint()
        new_id = count + 1  # reference id quirk (src/bpe.c:171)
        if win_s not in str2id:
            count += 1
        str2id[win_s] = new_id
        if verbose and not replay:
            print(
                f"Most common pair: '{win_s.decode('utf-8', 'replace')}',"
                f" rank: {win_c}"
            )
            print(
                f"New token '{win_s.decode('utf-8', 'replace')}',"
                f" value: {new_id}\n"
            )

    if resume and checkpoint_path is not None and os.path.exists(
        checkpoint_path + ".merges"
    ):
        with open(checkpoint_path + ".merges", encoding="utf-8") as f:
            replay = [
                bytes.fromhex(line.split()[1])
                for line in f
                if line.startswith("s ")
            ]
        for s in replay:
            bookkeep(s, -1, replay=True)
            apply_winner(s)
            prev_key = s
        merges_since_ckpt = 0
        if verbose:
            print(f"resumed {len(replay)} merges from {checkpoint_path}")

    # recurring near-tie contenders (see the scan driver): insertion-
    # ordered, oldest evicted beyond PROBE_P
    watch: dict[tuple[int, int], None] = {}

    def watch_queries():
        """(the watched pairs, their (qa, qb) on the device)."""
        wlist = list(watch)[:PROBE_P]
        q = np.full((2, PROBE_P), -1, np.int32)
        for i, (x, y) in enumerate(wlist):
            q[0, i], q[1, i] = x, y
        q = _upload(q, dev0)
        return wlist, q[0], q[1]

    def _nlen() -> int:
        """Distinct csid spelling lengths — the sharp unseen-group
        factor.  Any string has at most this many parses into two
        existing spellings: distinct parses have distinct LEFT lengths,
        and each left part must be a spelling, so its length lies in
        the spelling-length set.  (Replaces the looser 2L-1 split-count
        bound; the difference decides certification in the tail, where
        win counts approach the parse-count scale.)"""
        return len({len(s) for s in spell2csid})

    _deep = {"ops": None}

    def deep_exec(ids_now, pend):
        """The fused tail step: apply ``pend`` = (c1, c2, g) (a no-op
        when None), run the DEEP candidate count (k = DEEP_K — the Fagin
        bound B lands in the count tail, usually 0-1, so the nlen-guard
        certifies far past the scan's k_top) and probe the watch-list,
        with ONE download; returns (new_ids, parse of the deep table).
        Parse result: (win_s, win_c) or None when even the deep bound
        cannot certify (caller falls back to the host pick)."""
        if _deep["ops"] is None:
            _deep["ops"] = _make_shard_ops(2, mesh, k_top=DEEP_K)
        ops2 = _deep["ops"]
        noc = np.full(MAXC, -1, np.int32)
        c1a, c2a, g = (noc, noc, 0) if pend is None else pend
        wlist, qa, qb = watch_queries()
        c = _upload(np.stack([c1a, c2a]), dev0)
        ids2 = ops2["apply_merge_multi"](ids_now, c[0], c[1], g)
        ga, gb, cnt, sh, lpos, bound = ops2["count_candidates"](ids2)
        arr = _packed(
            ga, gb, cnt, sh, lpos, *ops2["probe_pairs"](ids2, qa, qb), bound
        ).cpu().numpy()
        K = (arr.shape[0] - 1 - 3 * PROBE_P) // 5
        ga, gb, cnt = arr[0:K], arr[K : 2 * K], arr[2 * K : 3 * K]
        sh, lpos = arr[3 * K : 4 * K], arr[4 * K : 5 * K]
        w0 = 5 * K
        wprobed = {
            pair: (int(arr[w0 + i]),
                   (int(arr[w0 + PROBE_P + i]) << 32)
                   | (int(arr[w0 + 2 * PROBE_P + i]) & 0xFFFFFFFF))
            for i, pair in enumerate(wlist)
        }
        B = int(arr[-1])
        return ids2, self_pick(ids2, ga, gb, cnt, sh, lpos, B, wprobed)

    def probe(ids_now, need):
        """``probe_step`` of the query pairs ``need`` (at most PROBE_P):
        their (count, shard, position) rows on the host."""
        q = np.full((2, PROBE_P), -1, np.int32)
        for i, (x, y) in enumerate(need):
            q[0, i], q[1, i] = x, y
        q = _upload(q, dev0)
        return torch.stack(probe_step(ids_now, q[0], q[1])).cpu().numpy()

    def self_pick(ids_now, ga, gb, cnt, sh, lpos, B, wprobed):
        """Exact group pick over a deep candidate table.

        Group aggregation is vectorized: pair spellings compare by a
        64-bit rolling hash (H(ab) = H(a) + P^len(a)*H(b)), and the few
        groups within reach of the winner are re-verified by REAL
        concatenation before anything rides on the hash; their
        uncounted compositions come from the watch probe or one extra
        probe_pairs dispatch.  Groups further than nlen*B below the
        winner cannot win or tie (every uncounted pair counts <= B).
        Returns (win_s, win_c) or None (fall back to the host pick)."""
        hi_ = 0x7FFFFFFF
        vmask = (ga != hi_) & (cnt > 0)
        if not vmask.any():
            return None
        nlen = _nlen()
        cmax = int(cnt[vmask].max())
        # thr >= 1: count-1 pairs can only matter via the bound, and
        # folding them into B_eff keeps the aggregation at the count>=2
        # pair set (the whole point of the deep table is B_eff ~ 1)
        thr = max(1, cmax // (2 * nlen + 2))
        if thr > B and (cnt > thr).any():
            B = thr
            vmask &= cnt > thr
        idx = np.flatnonzero(vmask)
        # one row per pair: the union lists a pair once per shard whose
        # top-k holds it, every row with the pair's exact global stats
        _keys, first = np.unique(
            (ga[idx].astype(np.int64) << 31) | gb[idx], return_index=True
        )
        idx = idx[np.sort(first)]
        a, b = ga[idx], gb[idx]
        c = cnt[idx].astype(np.int64)
        last = (sh[idx].astype(np.int64) << 32) | lpos[idx].astype(
            np.int64
        )
        st = _sh_state
        with np.errstate(over="ignore"):  # mod-2^64 rolling hash
            gkey = st["h"][a] + np.power(
                _HP, st["l"][a].astype(np.uint64)
            ) * st["h"][b]
        order = np.argsort(gkey, kind="stable")
        gk = gkey[order]
        newg = np.concatenate(([True], gk[1:] != gk[:-1]))
        gstart = np.flatnonzero(newg)
        ng = gstart.shape[0]
        # a group's rows are contiguous in key order: reduce each run
        gcnt = np.add.reduceat(c[order], gstart)
        glast = np.maximum.reduceat(last[order], gstart)
        # winner among groups: max count, tie-break min last
        wcnt = int(gcnt.max())
        if B > 0 and wcnt <= nlen * B:
            return None  # even the deep bound cannot certify
        # contenders: only groups within nlen*B of the winner can reach
        # it via uncounted compositions (each <= B)
        cand = np.flatnonzero(gcnt >= wcnt - nlen * B)
        need: list[tuple[int, int]] = []
        metas = []
        for g in cand.tolist():
            lo = gstart[g]
            hi2 = gstart[g + 1] if g + 1 < ng else gk.shape[0]
            rows = order[lo:hi2].tolist()
            sp0 = (
                csid2spell[int(a[rows[0]])] + csid2spell[int(b[rows[0]])]
            )
            pairs_g = set()
            for r in rows:
                if csid2spell[int(a[r])] + csid2spell[int(b[r])] != sp0:
                    return None  # hash collision: punt to the host pick
                pairs_g.add((int(a[r]), int(b[r])))
            missing = [
                q for q in comps_of(sp0)
                if q not in pairs_g and q not in wprobed
            ]
            pre = [
                q for q in comps_of(sp0)
                if q not in pairs_g and q in wprobed
            ]
            need.extend(missing)
            metas.append((g, sp0, missing, pre))
        need = list(dict.fromkeys(need))
        for q in need:  # future deep steps probe these inline
            watch.pop(q, None)
            watch[q] = None
        while len(watch) > PROBE_P:
            watch.pop(next(iter(watch)))
        probed: dict[tuple[int, int], tuple[int, int]] = dict(wprobed)
        if need:
            if len(need) > PROBE_P:
                return None
            pc, psh, plp = probe(ids_now, need)
            for i, q in enumerate(need):
                probed[q] = (
                    int(pc[i]),
                    (int(psh[i]) << 32) | (int(plp[i]) & 0xFFFFFFFF),
                )
        best = None
        for g, sp0, missing, pre in metas:
            tot = int(gcnt[g])
            lst = int(glast[g])
            for q in missing + pre:
                qc, ql = probed[q]
                tot += qc
                if qc > 0:
                    lst = max(lst, ql)
            key = (-tot, lst)
            if best is None or key < best[0]:
                best = (key, sp0, tot)
        return best[1], best[2]

    group_pick = _make_shard_ops(2, mesh, k_top=k_top)["group_pick"]

    def exact_pick(ids_now):
        """The exact group pick, (win_s, [win_c, last]) or None when no
        pair is left: on the device (``group_pick``) with the winner's
        pairs checked by real concatenation, or on the host
        (``_host_exact_string_pick``, which downloads the stream and
        aggregates every pair in Python, 0.5 s a call at 4 M ids) when a
        hash collision joined the winner's group to another."""
        st = _sh_state
        with np.errstate(over="ignore"):
            gp = np.power(_HP, st["l"][: st["n"]].astype(np.uint64))
        tabs = _upload(np.stack([st["h"][: st["n"]], gp]).view(np.int64), dev0)
        got = group_pick(ids_now, tabs[0], tabs[1])
        if got is None:
            return None
        win_c, last, pairs = got
        spells = {csid2spell[int(k) >> 31] + csid2spell[int(k) & ID_MASK] for k in pairs}
        if len(spells) == 1:
            return spells.pop(), [win_c, last]
        return _host_exact_string_pick(_fetch_global(ids_now, mesh), csid2spell)

    def deep_pick(ids_now):
        """Standalone exact pick (no pending merge) — the scan and
        classic loops' fallback when their k_top bound cannot certify."""
        _ids2, picked = deep_exec(ids_now, None)
        return picked

    def resolve_near_ties(ids_now, groups, ps, B):
        """Settle an uncertified pick by querying ONLY the uncounted
        compositions of the winner and every contending group
        (``probe_pairs``: one tiny dispatch), instead of downloading
        the full id stream for a host pick.  Caller must have verified
        the unseen-group guard (win_c > nlen * B).  Returns
        (win_s, win_c) or None when > PROBE_P queries would be needed.

        Exactness: after the probe every contender's count and
        last-occurrence are exact; non-contenders satisfy
        count <= cc + missing*B < win_c <= final winner count, so they
        can neither win nor tie."""
        win_s, (win_c, _wl) = _pick_group(groups)
        need: list[tuple[int, int]] = []
        for s, (cc, _l) in groups.items():
            missing = [c for c in comps_of(s) if c not in ps]
            if not missing:
                continue
            if s == win_s or win_c <= cc + len(missing) * B:
                need.extend(missing)
        need = list(dict.fromkeys(need))
        for p in need:  # future chunks probe these inline
            watch.pop(p, None)
            watch[p] = None
        while len(watch) > PROBE_P:
            watch.pop(next(iter(watch)))
        if not need:
            return win_s, win_c
        if len(need) > PROBE_P:
            return None
        cnt, sh, lp = probe(ids_now, need)
        ps2 = dict(ps)
        for i, (x, y) in enumerate(need):
            if cnt[i] > 0:
                ps2[(x, y)] = (int(cnt[i]), (int(sh[i]), int(lp[i])))
        w2, (c2, _l2) = _pick_group(_group_stats(ps2, csid2spell))
        return w2, c2

    # ---- scan-batched speculative driver (default): S merges per
    # chunk with host-side exact validation and rollback (see
    # make_string_scan_step).  HUTOKEN_TPU_STRING_SCAN=0 selects the
    # per-merge loop below.
    sv = os.environ.get("HUTOKEN_TPU_STRING_SCAN", "16")
    try:
        S = max(int(sv), 0)
    except ValueError:
        S = 16
    if S > 1:
        scan_fn = make_string_scan_step(mesh, S, k_top=k_top)

        def parse_step(row, wlist):
            """Candidate rows -> pair dict, numpy-filtered to the pairs
            that can still influence the group pick.

            Pairs with count <= thr are dropped and thr is FOLDED INTO
            the bound (B_eff = max(B, thr)), so the validator's
            missing-composition and unseen-group formulas stay exact —
            a dropped pair is indistinguishable from a non-candidate.
            Without this the host parses k_top entries per sub-step in
            interpreted Python.  Watch-list rows are exact and bypass
            the filter."""
            Jv = (row.shape[0] - 4 - 3 * PROBE_P) // 5
            ga, gb, cnt = row[0:Jv], row[Jv : 2 * Jv], row[2 * Jv : 3 * Jv]
            sh, lpos = row[3 * Jv : 4 * Jv], row[4 * Jv : 5 * Jv]
            w0 = 5 * Jv
            wc = row[w0 : w0 + PROBE_P]
            wsh = row[w0 + PROBE_P : w0 + 2 * PROBE_P]
            wlp = row[w0 + 2 * PROBE_P : w0 + 3 * PROBE_P]
            tail = w0 + 3 * PROBE_P
            B = int(row[tail])
            dev_pair = (int(row[tail + 1]), int(row[tail + 2]))
            vmask = (ga != hi) & (cnt > 0)
            if vmask.any():
                cmax = int(cnt[vmask].max())
                # keep thr low enough that the winner still clears the
                # nlen * B_eff unseen-group guard with 2x margin
                thr = cmax // (2 * _nlen() + 2)
                if thr > B:
                    B = thr
                    vmask &= cnt > thr
            idx = np.flatnonzero(vmask)
            ps: dict = {}
            for j in idx.tolist():
                ps[(int(ga[j]), int(gb[j]))] = (
                    int(cnt[j]), (int(sh[j]), int(lpos[j]))
                )
            for i, pair in enumerate(wlist):
                # count 0 is as load-bearing as a positive count: the
                # pair is then KNOWN absent, not "missing" — leaving it
                # out would keep its group uncertifiable forever
                ps[pair] = (int(wc[i]), (int(wsh[i]), int(wlp[i])))
            return ps, B, dev_pair

        stop_all = False
        demoted = False
        tail_streak = 0
        while count < vocab_size and not stop_all and not demoted:
            cs_start = len(csid2spell)
            saved = ids
            STRING_SCAN_STATS["chunks"] += 1
            wlist, qa, qb = watch_queries()
            ids2, packed = scan_fn(ids, cs_start, qa, qb)
            arr = packed.cpu().numpy()  # the chunk's one download
            n_valid = 0
            applied: list[tuple[int, int]] = []
            divergent: "tuple | None" = None
            for i in range(arr.shape[0]):
                if count >= vocab_size:
                    break
                ps, B, dev_pair = parse_step(arr[i], wlist)
                if not ps:
                    stop_all = True  # < two live elements (src/bpe.c:124)
                    break
                groups = _group_stats(ps, csid2spell)
                win_s, (win_c, _wl) = _pick_group(groups)
                safe = True
                can_query = False
                if B > 0:
                    safe = win_c > _nlen() * B
                    if safe:
                        for s, (cc, _l) in groups.items():
                            if s == win_s:
                                continue
                            missing = sum(
                                1 for comp in comps_of(s) if comp not in ps
                            )
                            # missing == 0 -> the competitor's count AND
                            # last-occurrence are exact, so an exact tie
                            # is already resolved by _pick_group's
                            # tie-break; only uncounted compositions
                            # make the comparison uncertain — and those
                            # resolve with a targeted probe after the
                            # rollback replay
                            if missing and win_c <= cc + missing * B:
                                safe = False
                                can_query = True
                                break
                if not safe:
                    if os.environ.get("HUTOKEN_TPU_STRING_DEBUG") == "1":
                        print(f"[sdbg] uncert win_c={win_c} B={B} "
                              f"guard={_nlen()*B} query={can_query}")
                    divergent = (
                        ("query", (groups, ps, B))
                        if can_query
                        else ("exact", None)
                    )
                    break
                comps = comps_of(win_s)
                if (
                    win_s in spell2csid
                    or len(comps) != 1
                    or comps[0] != dev_pair
                ):
                    # group semantics diverge from the device's pair
                    # speculation (multi-composition winner, different
                    # group winner, or a duplicate-spelling re-win)
                    divergent = ("apply", (win_s, win_c))
                    break
                bookkeep(win_s, win_c)
                intern_winner(win_s)  # assigns csid cs_start + i
                applied.append(dev_pair)
                n_valid += 1
                if prev_key is not None and prev_key == win_s:
                    stop_all = True  # repeat stop (src/bpe.c:221-224)
                    break
                prev_key = win_s
            else:
                # every sub-step validated: commit the chunk, and drop
                # the pad tail all shards share (each shard keeps one
                # length: the rollback and _host_apply_multi rely on it)
                live = int(pmax([(s >= 0).sum() for s in ids2], mesh))
                ids = [s[: max(live, trim_floor)] for s in ids2]
                STRING_SCAN_STATS["committed"] += 1
                continue
            if stop_all or count >= vocab_size:
                break
            # rollback to the chunk start, replay the validated prefix
            # (each a verified single-composition merge), then run the
            # divergent step exactly
            ids = saved
            for j in range(n_valid):
                ids = merge_multi(ids, *comp_arrays([applied[j]]), cs_start + j)
            kind, data = divergent
            STRING_SCAN_STATS["divergent"] += 1
            if kind == "query":
                # the replayed ids == the uncertified sub-step's state,
                # so its candidate stats are valid — settle the pick
                # with one tiny probe dispatch
                r = resolve_near_ties(ids, *data)
                if r is not None:
                    STRING_SCAN_STATS["probe_picks"] += 1
                    win_s, win_c = r
                else:
                    kind = "exact"
            if kind == "exact":
                # guard failures at the chunk's first sub-step mean the
                # tail regime has arrived (win counts at the parse-count
                # scale): every chunk would be wasted, so after a short
                # streak the lean tail loop (deep table every merge)
                # takes over
                if n_valid == 0:
                    tail_streak += 1
                    if tail_streak >= 3:
                        demoted = True
                else:
                    tail_streak = 0
                dp = deep_pick(ids)
                if dp is not None:
                    STRING_SCAN_STATS["deep_picks"] += 1
                    win_s, win_c = dp
                else:
                    STRING_SCAN_STATS["exact_picks"] += 1
                    picked = exact_pick(ids)
                    if picked is None:
                        break
                    win_s, (win_c, _wl) = picked
            elif kind == "apply":
                win_s, win_c = data
            bookkeep(win_s, win_c)
            g, comps = intern_winner(win_s)
            if len(comps) <= MAXC:
                ids = merge_multi(ids, *comp_arrays(comps), g)
            else:
                host_merge(comps, g)
            if prev_key is not None and prev_key == win_s:
                break
            prev_key = win_s
        if not demoted:
            checkpoint()
            return str2id
        # lean tail loop: once certification needs the deep bound every
        # merge, scan chunks and k_top counts are pure waste — ONE fused
        # step per merge applies the previous winner, deep-counts, and
        # probes the watch-list
        pend = None
        while count < vocab_size:
            ids, picked = deep_exec(ids, pend)
            pend = None
            if picked is None:
                picked = exact_pick(ids)
                if picked is None:
                    break
                win_s, (win_c, _wl) = picked
            else:
                win_s, win_c = picked
            bookkeep(win_s, win_c)
            g, comps = intern_winner(win_s)
            if len(comps) <= MAXC:
                pend = (*comp_arrays(comps), g)
            else:
                host_merge(comps, g)
            if prev_key is not None and prev_key == win_s:
                break
            prev_key = win_s
        if pend is not None:  # flush the deferred final merge
            ids = merge_multi(ids, *pend)
        checkpoint()
        return str2id

    # the winner's merge is DEFERRED into the next iteration's fused
    # string_step (merge + count = one step, one packed download);
    # ``pending`` holds the comps to apply
    noc = np.full(MAXC, -1, np.int32)
    pending: "tuple | None" = None
    while count < vocab_size:
        if pending is None:
            c1a, c2a, gid = noc, noc, 0
        else:
            c1a, c2a, gid = pending
            pending = None
        c = _upload(np.stack([c1a, c2a]), dev0)
        ids, packed = string_step(ids, c[0], c[1], gid)
        arr = packed.cpu().numpy()
        J = (arr.shape[0] - 1) // 5
        ga, gb, cnt, sh, lpos = (
            arr[0:J], arr[J : 2 * J], arr[2 * J : 3 * J],
            arr[3 * J : 4 * J], arr[4 * J : 5 * J],
        )
        B = int(arr[-1])
        vmask = (ga != hi) & (cnt > 0)
        if vmask.any():
            # same exactness-preserving candidate filter as the scan
            # driver's parse_step: drop pairs <= thr and fold thr into
            # the bound (a dropped pair == a non-candidate)
            cmax = int(cnt[vmask].max())
            thr = cmax // (2 * _nlen() + 2)
            if thr > B:
                B = thr
                vmask &= cnt > thr
        pair_stats: dict[tuple[int, int], tuple[int, tuple[int, int]]] = {}
        for j in np.flatnonzero(vmask).tolist():
            # "last occurrence" is the lexicographic (shard, local pos)
            # pair — overflow-free global ordering
            pair_stats[(int(ga[j]), int(gb[j]))] = (
                int(cnt[j]), (int(sh[j]), int(lpos[j]))
            )
        if not pair_stats:
            break  # fewer than two live elements (src/bpe.c:124)
        groups = _group_stats(pair_stats, csid2spell)
        win_s, (win_c, _win_l) = _pick_group(groups)
        if os.environ.get("HUTOKEN_TPU_TRAIN_SELFCHECK") == "1":
            ref = _host_exact_string_pick(_fetch_global(ids, mesh), csid2spell)
            if ref is not None and (
                ref[0] != win_s or ref[1][0] != win_c
            ):
                print(
                    f"[selfcheck] device pick {win_s!r} {groups[win_s]} "
                    f"!= host pick {ref[0]!r} {ref[1]} (B={B}); "
                    f"device stats for host pick: {groups.get(ref[0])}"
                )
        if B > 0:
            # certify: the winner's exact lower bound must beat every
            # other candidate group's upper bound and the unseen-group
            # bound (a spelling has at most _nlen() parses, each
            # contributing at most B when uncounted)
            safe = win_c > _nlen() * B
            can_query = False
            if safe:
                for s, (c, _l) in groups.items():
                    if s == win_s:
                        continue
                    missing = sum(
                        1
                        for comp in comps_of(s)
                        if comp not in pair_stats
                    )
                    # missing == 0 -> exact count and last-occurrence,
                    # so exact ties are already resolved by
                    # _pick_group's tie-break (see scan driver)
                    if missing and win_c <= c + missing * B:
                        safe = False
                        can_query = True
                        break
            if not safe:
                picked = (
                    resolve_near_ties(ids, groups, pair_stats, B)
                    if can_query
                    else None
                )
                if picked is None:
                    picked = deep_pick(ids)
                if picked is not None:
                    win_s, win_c = picked
                else:
                    picked = exact_pick(ids)
                    if picked is None:
                        break
                    win_s, (win_c, _win_l) = picked
        bookkeep(win_s, win_c)
        g, comps = intern_winner(win_s)
        if len(comps) <= MAXC:
            pending = (*comp_arrays(comps), g)  # applied next iteration
        else:
            host_merge(comps, g)
        if prev_key is not None and prev_key == win_s:
            break  # same spelling twice in a row (src/bpe.c:221-224)
        prev_key = win_s
    checkpoint()
    return str2id


def distributed_bpe_train(
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
    """String-keyed (spelling-group) training on the mesh's devices
    (``data_mesh()``: the card), optional checkpoint/resume; returns the
    vocab ``bpe_train_core(strict=False)`` returns.

    Pairs are grouped by concatenated SPELLING, so all compositions of
    the winning spelling count and merge together (src/bpe.c:130-165,
    181-215); see ``_distributed_train_string``.  The id-assignment
    quirk (count+1, skipping 256) is kept (src/bpe.c:171); repeat-stop
    compares merged spellings (src/bpe.c:221-224).  ``scan_steps`` is
    accepted for symmetry with ``distributed_bbpe_train`` but unused:
    the string trainer's chunks are ``HUTOKEN_TPU_STRING_SCAN`` long."""
    if not isinstance(mesh, DataMesh):
        raise TypeError(
            f"mesh must be a hutoken_tpu_torch.parallel.DataMesh (data_mesh()), "
            f"not {type(mesh).__name__}"
        )
    return _distributed_train_string(
        data, vocab_size, mesh,
        verbose=verbose,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        resume=resume,
    )

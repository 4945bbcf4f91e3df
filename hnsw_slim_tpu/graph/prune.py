"""Two-stage Slim pruning: HNSW LevelGraph -> compact CHAL graph.

Port of HierarchicalNSWSlim::convertFromHNSW (reference hnswalg_slim.h:867-1108)
as vectorized whole-array passes:

  1. degree histogram + per-level top-alpha% threshold walk  (:904-945)
  2. per-(node,level) heuristic prune to hub/low budgets      (:951-986)
  3. reverse-edge union + dedup                               (:988-998,:999-1015)
  4. re-prune to maxM0/maxM where the union overflows         (:1016-1062)
  5. hierarchical filter: keep neighbor u at level l only if
     element_level(u) == l, unless l == threshold_level       (:1063-1084)
  6. pack CHAL (flat ids + per-level prefix offsets)          (:1088-1106)

Quirk ported faithfully: the reference never increments level_cnts[0]
(hnswalg_slim.h:906-921), so the level-0 threshold walk sees topN=0 and picks
threshold maxM0+1 — i.e. EVERY level-0 node takes the low budget and
top_degree_percent0/top_M0 are effectively inert. The paper describes 2%
level-0 hubs; pass count_level0_hubs=True for that behavior.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import SlimConfig
from .heuristic import prune_batch
from .types import ChalGraph, LevelGraph


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def degree_thresholds(
    adj_np: list[np.ndarray],
    levels: np.ndarray,
    maxM0: int,
    cfg: SlimConfig,
    count_level0_hubs: bool = False,
) -> np.ndarray:
    """Per-level degree thresholds via the reference's histogram walk
    (hnswalg_slim.h:923-945): descend from the top degree, accumulate counts,
    stop when >= round(level_count * alpha)."""
    lmax = len(adj_np) - 1
    thr = np.zeros(lmax + 1, np.int64)
    for l in range(lmax + 1):
        act = levels >= l
        deg = (adj_np[l][act] >= 0).sum(axis=1)
        hist = np.bincount(deg, minlength=maxM0 + 2)
        if l == 0:
            cnt = int(act.sum()) if count_level0_hubs else 0  # reference quirk
            pct = cfg.top_degree_percent0
        else:
            cnt = int(act.sum())
            pct = cfg.top_degree_percent
        top_n = int(cnt * pct + 0.5)
        acc = 0
        for d in range(maxM0 + 1, 0, -1):
            acc += int(hist[d]) if d < len(hist) else 0
            if acc >= top_n:
                thr[l] = d
                break
    return thr


def _group_rows(src: np.ndarray, tgt: np.ndarray, act: np.ndarray, n: int):
    """Group sorted (src, tgt) pairs into left-aligned padded rows over `act`
    (ascending) node ids. Returns rows i32[len(act), W] (-1 padded)."""
    counts = np.bincount(src, minlength=n)[act]
    width = _next_pow2(int(counts.max(initial=1)))
    rows = np.full((len(act), width), -1, np.int32)
    row_idx = np.searchsorted(act, src)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(len(src)) - np.repeat(starts, counts)
    rows[row_idx, col] = tgt
    return rows, counts


def _sort_row_ids(rows: np.ndarray) -> np.ndarray:
    """Ascending-id canonical order with -1 padding pushed right."""
    big = np.where(rows < 0, np.iinfo(np.int32).max, rows)
    out = np.sort(big, axis=1)
    return np.where(out == np.iinfo(np.int32).max, -1, out).astype(np.int32)


def convert_to_slim(
    lg: LevelGraph,
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    cfg: SlimConfig,
    metric: str = "l2",
    count_level0_hubs: bool = False,
    chunk: int = 2048,
    verbose: bool = False,
) -> ChalGraph:
    levels = np.asarray(lg.level)
    n = len(levels)
    lmax = lg.max_level
    adj_np = [np.asarray(a) for a in lg.adjs]
    maxM0 = adj_np[0].shape[1]
    maxM = adj_np[1].shape[1] if lmax >= 1 else maxM0 // 2

    thr = degree_thresholds(adj_np, levels, maxM0, cfg, count_level0_hubs)

    import os
    import time as _time

    timing = os.environ.get("SLIM_TIMING")
    tmarks = []

    final_rows: list[np.ndarray] = []
    for l in range(lmax + 1):
        t0 = _time.perf_counter()
        act = np.nonzero(levels >= l)[0]
        a = adj_np[l][act]
        deg = (a >= 0).sum(axis=1)
        if l == 0:
            budget = np.where(deg > thr[l], cfg.top_M0, cfg.low_m0)
            out_w, cap_l = cfg.top_M0, maxM0
        else:
            budget = np.where(deg > thr[l], cfg.top_M, cfg.low_m)
            out_w, cap_l = cfg.top_M, maxM

        # stage 2: per-(node,level) budget prune (PruneByHeuristic, no
        # early-out) — one fused device dispatch over all active nodes
        from .heuristic import prune_all

        na = len(act)
        # canonical pad: every upper level shares ONE compiled program (a
        # fresh prune_all shape compiles far longer than pruning 32k padded
        # rows runs)
        npad = 32768 if na <= 32768 else -(-na // chunk) * chunk
        pruned = np.asarray(
            prune_all(
                vectors, vn,
                jnp.asarray(_pad_to_len(act.astype(np.int32), npad, 0)),
                jnp.asarray(_pad_to_len(a, npad, -1)),
                jnp.asarray(_pad_to_len(budget.astype(np.int32), npad, 1)),
                M=out_w, keep_all_under_m=False, metric=metric,
                out_width=out_w, chunk=chunk,
            )
        )[:na]
        if timing:
            tmarks.append((f"L{l}.stage2[{na}]", _time.perf_counter() - t0))
            t0 = _time.perf_counter()

        # stage 3: reverse union + dedup (sorted by id). Shift-packed keys:
        # the previous (src * n + tgt) encoding paid a 48M-element int64
        # division to decode (~100 s of the 1M convert); shifts are free
        s_ids = np.repeat(act, out_w)
        t_ids = pruned.ravel()
        m = t_ids >= 0
        s_ids, t_ids = s_ids[m], t_ids[m]
        key = np.unique(
            np.concatenate([
                (s_ids.astype(np.int64) << np.int64(31)) | t_ids,
                (t_ids.astype(np.int64) << np.int64(31)) | s_ids,
            ])
        )
        u_src = (key >> np.int64(31)).astype(np.int64)
        u_tgt = (key & np.int64((1 << 31) - 1)).astype(np.int32)
        rows, counts = _group_rows(u_src, u_tgt, act, n)
        if timing:
            tmarks.append((f"L{l}.union", _time.perf_counter() - t0))
            t0 = _time.perf_counter()

        # stage 4: re-prune rows overflowing the level cap
        over = np.nonzero(counts > cap_l)[0]
        if len(over):
            cand = rows[over]
            # chunk scales down with row width: the prune's pairwise-distance
            # tensor is [chunk, W, W] f32, and NND-built hubs can push W to
            # 1024+ (8.6 GB at chunk 2048)
            w = cand.shape[1]
            cw = max(64, min(chunk, (chunk * 512 * 512) // (w * w)))
            for s in range(0, len(over), cw):
                ck = slice(s, min(s + cw, len(over)))
                cpad, nv = _pad(cand[ck]), ck.stop - ck.start
                sel, _ = prune_batch(
                    vectors, vn,
                    jnp.asarray(_pad(act[over][ck], fill=0)),
                    jnp.asarray(cpad),
                    jnp.asarray(cpad >= 0),
                    M=cap_l, keep_all_under_m=False, metric=metric,
                    out_width=cap_l,
                )
                out = np.full((cpad.shape[0], rows.shape[1]), -1, np.int32)
                out[:, :cap_l] = np.asarray(sel)
                rows[over[ck]] = _sort_row_ids(out)[:nv]
        if rows.shape[1] > cap_l:
            assert not (rows[:, cap_l:] >= 0).any()
            rows = rows[:, :cap_l]
        if timing:
            tmarks.append((f"L{l}.cap[{len(over)}]", _time.perf_counter() - t0))
            t0 = _time.perf_counter()

        # stage 5: hierarchical level filter
        if l != cfg.threshold_level:
            keep = (rows >= 0) & (levels[np.maximum(rows, 0)] == l)
            filt = np.where(keep, rows, -1)
            rows = _sort_row_ids(filt)

        full = np.full((n, rows.shape[1]), -1, np.int32)
        full[act] = rows
        if l == cfg.threshold_level:
            # pruning may sever thin bridges; re-guarantee a single component
            # at the beam-entry level (membership rule is exempt here, and the
            # reference's reverse-edge union serves the same purpose,
            # hnswalg_slim.h:988-998)
            from .build import repair_connectivity

            full[act] = repair_connectivity(
                full[act], act.astype(np.int32), vectors, vn, metric
            )
        if timing:
            tmarks.append((f"L{l}.filt+repair", _time.perf_counter() - t0))
        final_rows.append(full)
        if verbose:
            kept = (final_rows[l] >= 0).sum()
            print(f"  slim level {l}: thr={thr[l]} edges={kept}")

    if timing:
        print("  convert timing: " + " ".join(
            f"{k}={v:.2f}s" for k, v in tmarks if v >= 0.05
        ), flush=True)
    return pack_chal_arrays(
        final_rows, levels,
        entry=int(np.asarray(lg.entry)),
        max_level=lmax,
        threshold_level=cfg.threshold_level,
        cap0=maxM0,
        cap=maxM,
    )


def level_indegrees(adj_np: list[np.ndarray], levels: np.ndarray) -> list[np.ndarray]:
    """Per-(node, level) in-degree of the donor graph
    (hnswalg_slimzero.h:966-1000 scatter-add pass)."""
    n = len(levels)
    out = []
    for l, a in enumerate(adj_np):
        act = levels >= l
        vals = a[act].reshape(-1)
        vals = vals[vals >= 0]
        out.append(np.bincount(vals, minlength=n).astype(np.int64))
    return out


def convert_to_slimzero(
    lg: LevelGraph,
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    cfg: SlimConfig,
    metric: str = "l2",
    count_level0_hubs: bool = False,
    chunk: int = 2048,
    verbose: bool = False,
    state: dict | None = None,
) -> ChalGraph:
    """SlimZero conversion (hnswalg_slimzero.h convertFromHNSW :940-1150):
    same hub/low budgets, but NO reverse-edge union — connectivity is
    preserved by an in-degree guard instead: any neighbor whose in-degree is
    <= min_indegree is kept unconditionally.

    Deviation from the reference: the reference decrements a shared atomic
    in-degree array as it prunes (OpenMP order-dependent); here the guard
    uses a snapshot of donor in-degrees, then one repair iteration restores
    the nearest in-edge of any node whose post-prune in-degree fell below
    the floor. Same invariant, deterministic result.

    `state`, if given, captures the per-level conversion state the
    incremental diff path (IncrementalSlimZero, counterpart of
    convertFromHNSWWithDiff hnswalg_slimzero.h:1590-1660) needs:
    final rows, budgets, thresholds.
    """
    from .heuristic import prune_batch_guarded

    levels = np.asarray(lg.level)
    n = len(levels)
    lmax = lg.max_level
    adj_np = [np.asarray(a) for a in lg.adjs]
    maxM0 = adj_np[0].shape[1]
    maxM = adj_np[1].shape[1] if lmax >= 1 else maxM0 // 2

    thr = degree_thresholds(adj_np, levels, maxM0, cfg, count_level0_hubs)
    indeg = level_indegrees(adj_np, levels)

    final_rows: list[np.ndarray] = []
    for l in range(lmax + 1):
        act = np.nonzero(levels >= l)[0]
        a = adj_np[l][act]
        deg = (a >= 0).sum(axis=1)
        if l == 0:
            budget = np.where(deg > thr[l], cfg.top_M0, cfg.low_m0)
            cap_l, m_rev = maxM0, cfg.min_indegree0
        else:
            budget = np.where(deg > thr[l], cfg.top_M, cfg.low_m)
            cap_l, m_rev = maxM, cfg.min_indegree
        # Adaptive guard over sequential chunks: the reference decrements a
        # SHARED in-degree counter on every discard, so the guard set grows
        # during the pass and late prunes preserve nodes whose in-edges the
        # early prunes ate (hnswalg_slimzero.h:855,884 — racy under OpenMP;
        # here chunk-ordered and deterministic). A pure donor-snapshot guard
        # collapses at scale: 1M measured recall 0.005 vs the reference's
        # 0.23 on identical data — almost every in-edge is pruned before the
        # snapshot would ever fire.
        indeg_live = indeg[l].copy()
        gchunk = 8192
        rows = np.full((len(act), a.shape[1]), -1, np.int32)
        for s in range(0, len(act), gchunk):
            ck = slice(s, min(s + gchunk, len(act)))
            ack = a[ck]
            guard_ck = indeg_live[np.maximum(ack, 0)] <= m_rev
            cpad = _pad(ack)
            sel, _ = prune_batch_guarded(
                vectors, vn,
                jnp.asarray(_pad(act[ck], fill=0)),
                jnp.asarray(cpad),
                jnp.asarray(cpad >= 0),
                jnp.asarray(_pad(guard_ck.astype(np.int8), fill=0).astype(bool)),
                M=int(a.shape[1]), metric=metric, out_width=int(a.shape[1]),
                m_per_row=jnp.asarray(
                    _pad(budget[ck].astype(np.int32), fill=1)),
            )
            out_ck = np.asarray(sel)[: ck.stop - ck.start]
            rows[ck] = out_ck
            # decrement live counters by this chunk's discards
            kept_ct = np.bincount(
                out_ck[out_ck >= 0], minlength=n
            )
            all_ct = np.bincount(ack[ack >= 0], minlength=n)
            indeg_live -= all_ct - kept_ct

        # In-degree floor repair. The reference's PruneByHeuristic decrements
        # SHARED in-degree counters as it prunes, so its guard set grows
        # adaptively during the pass (hnswalg_slimzero.h:820-894, racy under
        # OpenMP). The snapshot guard above only protects nodes already at
        # the floor in the DONOR graph — at 1M the prune (deg ~24 -> ~5)
        # strips in-degrees so hard that most nodes end below the floor and
        # search collapses (measured recall 0.006). This deterministic repair
        # restores the same invariant: for every node with post-prune
        # in-degree < m_rev, re-add donor in-edges (from vanilla rows that
        # contained it) until the floor or the donor supply is reached.
        post = np.bincount(
            rows.reshape(-1)[rows.reshape(-1) >= 0], minlength=n
        )
        starved = np.nonzero(
            (post < m_rev) & (levels >= l)
        )[0] if len(act) else []
        if len(starved) and (adj_np[l][act] >= 0).any():
            m2 = adj_np[l][act] >= 0
            tgts = adj_np[l][act][m2]
            src_rows = np.repeat(
                np.arange(len(act)), m2.sum(axis=1)
            ).astype(np.int64)
            order = np.argsort(tgts, kind="stable")  # stable: lowest row 1st
            ts, rs = tgts[order].astype(np.int64), src_rows[order]
            lo = np.searchsorted(ts, starved)
            hi = np.searchsorted(ts, starved, side="right")
            # drop donors that already kept the edge (they count in post)
            kept_keys = None
            need = np.minimum(
                (m_rev - post[starved]).clip(min=0), hi - lo
            ).astype(np.int64)
            # oversample donors by the per-node kept count, then filter
            over_need = np.minimum(
                need + post[starved], hi - lo
            ).astype(np.int64)
            total = int(over_need.sum())
            if total:
                off = np.concatenate([[0], np.cumsum(over_need)[:-1]])
                flat = (np.arange(total) - np.repeat(off, over_need)
                        + np.repeat(lo, over_need))
                r_list = rs[flat]
                u_list = np.repeat(starved.astype(np.int64), over_need)
                # kept (row, tgt) pairs in the pruned rows
                mk = rows >= 0
                kept_keys = np.sort(
                    np.repeat(np.arange(len(act)), mk.sum(axis=1))
                    * np.int64(n) + rows[mk]
                )
                cand_keys = r_list * np.int64(n) + u_list
                pos2 = np.searchsorted(kept_keys, cand_keys)
                dup = np.zeros(len(cand_keys), bool)
                inb = pos2 < len(kept_keys)
                dup[inb] = kept_keys[pos2[inb]] == cand_keys[inb]
                r_list, u_list = r_list[~dup], u_list[~dup]
                # cap restores per node at its need (donors are in stable
                # lowest-row order; the floor is a connectivity invariant,
                # not a proximity one)
                need_of = np.zeros(n, np.int64)
                need_of[starved] = need
                order_u = np.argsort(u_list, kind="stable")
                uu, rr = u_list[order_u], r_list[order_u]
                runstart = np.searchsorted(uu, uu)
                rank_u = np.arange(len(uu)) - runstart
                keep2 = rank_u < need_of[uu]
                uu, rr = uu[keep2], rr[keep2]
                # scatter into free slots, grouped per donor row
                order_r = np.argsort(rr, kind="stable")
                rr, uu = rr[order_r], uu[order_r]
                runstart = np.searchsorted(rr, rr)
                rank_r = np.arange(len(rr)) - runstart
                base_cnt = (rows >= 0).sum(axis=1)
                slot = base_cnt[rr] + rank_r
                okslot = slot < rows.shape[1]
                rows[rr[okslot], slot[okslot]] = uu[okslot]

        # cap re-prune where over (plain PruneByHeuristic, :1085-1105)
        counts = (rows >= 0).sum(axis=1)
        over = np.nonzero(counts > cap_l)[0]
        out_rows = np.full((len(act), cap_l), -1, np.int32)
        under = counts <= cap_l
        w = min(cap_l, rows.shape[1])
        out_rows[under, :w] = _sort_row_ids(rows[under])[:, :w]
        if len(over):
            for s in range(0, len(over), chunk):
                ck = slice(s, min(s + chunk, len(over)))
                cpad = _pad(rows[over][ck])
                sel, _ = prune_batch(
                    vectors, vn,
                    jnp.asarray(_pad(act[over][ck], fill=0)),
                    jnp.asarray(cpad),
                    jnp.asarray(cpad >= 0),
                    M=cap_l, keep_all_under_m=False, metric=metric,
                    out_width=cap_l,
                )
                out_rows[over[ck]] = _sort_row_ids(
                    np.asarray(sel)[: ck.stop - ck.start]
                )
        rows = out_rows

        # hierarchical filter (same as Slim)
        if l != cfg.threshold_level:
            keep = (rows >= 0) & (levels[np.maximum(rows, 0)] == l)
            rows = _sort_row_ids(np.where(keep, rows, -1))

        full = np.full((n, rows.shape[1]), -1, np.int32)
        full[act] = rows
        if l == cfg.threshold_level:
            from .build import repair_connectivity

            full[act] = repair_connectivity(
                full[act], act.astype(np.int32), vectors, vn, metric
            )
        final_rows.append(full)
        if state is not None:
            b_full = np.zeros(n, np.int32)
            b_full[act] = budget
            state.setdefault("budgets", []).append(b_full)
        if verbose:
            print(f"  slimzero level {l}: thr={thr[l]} edges={(full >= 0).sum()}")

    if state is not None:
        state["final"] = final_rows
        state["thr"] = thr
        state["caps"] = [maxM0] + [maxM] * lmax
        state["levels"] = levels.copy()
        state["entry"] = int(np.asarray(lg.entry))
        state["lmax"] = lmax
    return pack_chal_arrays(
        final_rows, levels,
        entry=int(np.asarray(lg.entry)),
        max_level=lmax,
        threshold_level=cfg.threshold_level,
        cap0=maxM0,
        cap=maxM,
    )


def _pad_to_len(a: np.ndarray, size: int, fill: int) -> np.ndarray:
    if a.shape[0] >= size:
        return a
    pad = np.full((size - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def _pad(a: np.ndarray, fill: int = -1) -> np.ndarray:
    m = _next_pow2(a.shape[0])
    if m == a.shape[0]:
        return a
    return np.concatenate([a, np.full((m - a.shape[0],) + a.shape[1:], fill, a.dtype)])


def pack_chal_arrays(
    per_level_rows: list[np.ndarray],
    levels: np.ndarray,
    entry: int,
    max_level: int,
    threshold_level: int,
    cap0: int,
    cap: int,
    return_host: bool = False,
    device: bool = True,
) -> ChalGraph:
    """Vectorized CHAL packing (hnswalg_slim.h:1088-1106): flat neighbor ids
    grouped per node, per level, with absolute prefix offsets.
    return_host=True also returns the host numpy dict (nbr/lvl_off/level)
    so patch/persist consumers skip the device->host round trip.
    device=False skips the device upload entirely and returns a ChalGraph
    whose nbr/lvl_off/level are the HOST numpy arrays — for serving stacks
    that run on the dense0/dense_up layouts and keep the flat CHAL only for
    patches/persistence (the ~130 MB re-upload per /updateIndex at 1M was
    the single largest term of the warm update)."""
    import os
    import time as _time

    from ..utils import native

    timing = os.environ.get("SLIM_TIMING")
    t0 = _time.perf_counter()
    n = len(levels)
    lcnt = max_level + 1
    packed = native.chal_pack(per_level_rows, levels)
    if packed is not None:  # C single-pass: ~0.3 s at 1M vs ~40 s in numpy
        lvl_off32, nbr = packed
        total = len(nbr)
        e_pad = max(1024, _next_pow2(total))
        flat = np.full(e_pad, -1, np.int32)
        flat[:total] = nbr
        lvl_off = lvl_off32.astype(np.int64)
    else:
        counts = np.zeros((n, lcnt), np.int64)
        for l in range(lcnt):
            counts[:, l] = (
                (per_level_rows[l] >= 0) & (levels >= l)[:, None]
            ).sum(axis=1)
        node_total = counts.sum(axis=1)
        node_start = np.concatenate([[0], np.cumsum(node_total)[:-1]])
        lvl_off = np.zeros((n, lcnt + 1), np.int64)
        lvl_off[:, 0] = node_start
        for l in range(lcnt):
            lvl_off[:, l + 1] = lvl_off[:, l] + counts[:, l]

        total = int(node_total.sum())
        e_pad = max(1024, _next_pow2(total))
        flat = np.full(e_pad, -1, np.int32)
        for l in range(lcnt):
            rows = per_level_rows[l]
            mask = (rows >= 0) & (levels >= l)[:, None]
            rank = np.cumsum(mask, axis=1) - 1
            tgt = lvl_off[:, l][:, None] + rank
            flat[tgt[mask]] = rows[mask]
    if timing:
        print(f"    pack host={_time.perf_counter()-t0:.2f}s "
              f"(native={packed is not None})", flush=True)
        t0 = _time.perf_counter()

    lvl_off32 = lvl_off.astype(np.int32)
    lvl32 = levels.astype(np.int32)
    graph = ChalGraph(
        nbr=jnp.asarray(flat) if device else flat,
        lvl_off=jnp.asarray(lvl_off32) if device else lvl_off32,
        level=jnp.asarray(lvl32) if device else lvl32,
        entry=jnp.asarray(np.int32(entry)),
        max_level=int(max_level),
        threshold_level=int(threshold_level),
        cap0=int(cap0),
        cap=int(cap),
        # level -1 marks capacity-padding rows: logical count excludes them
        n_real=int((levels >= 0).sum()),
    )
    if timing and device:
        import jax

        jax.block_until_ready((graph.nbr, graph.lvl_off, graph.level))
        print(f"    pack h2d={_time.perf_counter()-t0:.2f}s", flush=True)
    if return_host:
        return graph, dict(nbr=flat, lvl_off=lvl_off32, level=lvl32)
    return graph

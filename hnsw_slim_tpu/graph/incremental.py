"""Incremental Slim conversion: re-prune only what an update touched.

The reference re-prunes the ENTIRE graph on every /updateIndex
(convertFromHNSWWithDiff, hnswalg_slim.h:1110-1424) — that full pass is why
its 1000-vector batches cost seconds (paper Table 4). Here the conversion
pipeline keeps its intermediate state so an update only recomputes:

  stage 2 (budget prune)      nodes whose vanilla adjacency or hub budget
                              changed                 (hnswalg_slim.h:951-986)
  stage 3 (reverse union)     the edge-key delta from those rows
                                                      (hnswalg_slim.h:988-1015)
  stage 4/5 (cap + filter)    nodes whose union membership changed
                                                      (hnswalg_slim.h:999-1084)

The output is IDENTICAL to a full convert_to_slim pass over the updated
vanilla graph (asserted by tests/test_incremental.py): same stages, same
kernels, same chunk shapes — only the node set shrinks. The degree-threshold
walk (:923-945) is recomputed every update from the full histogram (cheap);
a threshold shift re-prunes exactly the nodes whose budget flipped.

One deliberate exception: connectivity-repair edges. full() runs
repair_connectivity at the threshold level (the NND build path needs it) and
records the edges it added; update() re-applies those recorded edges to any
recomputed row (stage 4/5 rebuilds rows from the union, which never contained
them), so bridges survive arbitrarily many update batches. When full()'s
repair was a no-op (insertion-built bases) the recorded set is empty and the
identical-to-full contract holds exactly; otherwise update() preserves the
ORIGINAL bridges rather than re-deriving them (set repair_updates=True to
re-run the components pass per batch instead).

Union edges are kept as one sorted int64 key array per level,
key = src << 31 | tgt; a directed key exists iff either direction is a
stage-2 edge — matching the unique(src,tgt ∪ tgt,src) of the full pass.
"""

from __future__ import annotations

import numpy as np

from ..config import SlimConfig
from .types import ChalGraph

_SHIFT = np.int64(31)


def _keys_of(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    return (src.astype(np.int64) << _SHIFT) | tgt.astype(np.int64)


def _row_edges(rows: np.ndarray, ids: np.ndarray):
    """(src, tgt) arrays over valid entries of rows (ids aligned)."""
    m = rows >= 0
    return np.repeat(ids, m.sum(axis=1)), rows[m]


def _added_keys(pre: np.ndarray, post: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Directed (src, tgt) keys present in `post` rows but not `pre` rows."""
    s1, t1 = _row_edges(post, ids)
    s0, t0 = _row_edges(pre, ids)
    return np.setdiff1d(_keys_of(s1, t1), _keys_of(s0, t0))


def _sorted_merge(keys: np.ndarray, add: np.ndarray, rem: np.ndarray):
    """keys sorted; remove `rem` then insert `add` (both deduped)."""
    if len(rem):
        pos = np.searchsorted(keys, rem)
        ok = keys[np.minimum(pos, len(keys) - 1)] == rem
        keep = np.ones(len(keys), bool)
        keep[pos[ok]] = False
        keys = keys[keep]
    if len(add):
        # np.union1d re-sorts the whole 24M-key array (~seconds per level
        # per update); the delta is tiny, so a searchsorted + O(n) memmove
        # insert keeps the array sorted at linear cost
        add = np.unique(add)
        keys = np.insert(keys, np.searchsorted(keys, add), add)
    return keys


class IncrementalSlim:
    """Stateful convertFromHNSW: full() once, then update(touched) per batch.

    State per level: thr (degree threshold), budgets, stage-2 pruned rows,
    the union key array, and the final (post-filter) rows the CHAL packer
    consumes. All host-side numpy except the prune kernels.
    """

    def __init__(self, cfg: SlimConfig, metric: str = "l2",
                 count_level0_hubs: bool = False, chunk: int = 2048,
                 repair_updates: bool = False):
        self.cfg = cfg
        self.metric = metric
        self.count_level0_hubs = count_level0_hubs
        self.chunk = chunk
        # Whether update() re-runs the whole-graph connectivity repair.
        # full() always repairs (the NND build path needs it); updates on an
        # insertion-maintained vanilla graph keep connectivity by
        # construction (every insert links into the existing graph,
        # hnswalg.h:1344-1367) and the reference's convertFromHNSWWithDiff
        # performs no repair either — so the default skips the ~30s+
        # full-graph components pass per batch.
        self.repair_updates = repair_updates
        # per-level state, filled by full()
        self.thr: np.ndarray | None = None
        self.budgets: list[np.ndarray] = []
        self.stage2: list[np.ndarray] = []
        self.keys: list[np.ndarray] = []
        self.final: list[np.ndarray] = []
        self.levels: np.ndarray | None = None
        self.entry = 0
        self.lmax = 0
        self.caps: list[int] = []
        self.out_ws: list[int] = []
        # directed (src, tgt) keys repair_connectivity added at the threshold
        # level; re-applied to recomputed rows so bridges survive updates
        self.repair_keys = np.zeros(0, np.int64)

    # ---- shared kernels ------------------------------------------------

    def _stage2_prune(self, vectors, vn, ids: np.ndarray, cand: np.ndarray,
                      budget: np.ndarray, out_w: int) -> np.ndarray:
        """Budget prune rows (PruneByHeuristic, hnswalg_slim.h:951-986) with
        the exact chunk shape of the full pass (fp-determinism across
        full/incremental)."""
        import jax.numpy as jnp

        from .heuristic import prune_all
        from .prune import _pad_to_len

        na = len(ids)
        if na == 0:
            return np.zeros((0, out_w), np.int32)
        # pow2 ladder above one chunk: updates see varying touched-set sizes
        # and every fresh padded shape costs a compile
        npad = (self.chunk if na <= self.chunk
                else 1 << (na - 1).bit_length())
        out = prune_all(
            vectors, vn,
            jnp.asarray(_pad_to_len(ids.astype(np.int32), npad, 0)),
            jnp.asarray(_pad_to_len(cand, npad, -1)),
            jnp.asarray(_pad_to_len(budget.astype(np.int32), npad, 1)),
            M=out_w, keep_all_under_m=False, metric=self.metric,
            out_width=out_w, chunk=self.chunk,
        )
        return np.asarray(out)[:na]

    def _cap_reprune(self, vectors, vn, ids: np.ndarray, rows: np.ndarray,
                     cap_l: int) -> np.ndarray:
        """Stage-4 re-prune of over-cap union rows (hnswalg_slim.h:1016-1062)."""
        import jax.numpy as jnp

        from .heuristic import prune_batch
        from .prune import _next_pow2, _pad_to_len, _sort_row_ids

        out = np.full((len(ids), cap_l), -1, np.int32)
        # chunk scales down with row width (the prune materializes a
        # [chunk, W, W] f32 pairwise tensor; wide hub rows would OOM HBM)
        w = _next_pow2(rows.shape[1])
        if w > rows.shape[1]:
            rows = np.pad(rows, ((0, 0), (0, w - rows.shape[1])),
                          constant_values=-1)
        cw = max(64, min(self.chunk, (self.chunk * 512 * 512) // (w * w)))
        for s in range(0, len(ids), cw):
            ck = slice(s, min(s + cw, len(ids)))
            # ONE canonical shape per width bucket: the chunk is padded to
            # the full cw even for tiny update sets, so warm updates reuse
            # exactly the programs full() compiled — varying pow2 lengths
            # were fresh-shape compiles mid-update, the warm-update tail
            sel, _ = prune_batch(
                vectors, vn,
                jnp.asarray(_pad_to_len(ids[ck], cw, 0)),
                jnp.asarray(_pad_to_len(rows[ck], cw, -1)),
                jnp.asarray(_pad_to_len(rows[ck] >= 0, cw, 0)),
                M=cap_l, keep_all_under_m=False, metric=self.metric,
                out_width=cap_l,
            )
            out[ck] = _sort_row_ids(np.asarray(sel)[: ck.stop - ck.start])
        return out

    def prewarm(self, vectors, vn, widths=(64, 128, 256, 512, 1024)) -> None:
        """Compile the stage-4 cap-reprune programs for every union-width
        bucket an update can produce, so no warm batch ever pays a fresh
        compile. One-time cost right after full() (server startup);
        buckets full() already hit are cache hits here."""
        for w in widths:
            ids = np.zeros(1, np.int64)
            rows = np.full((1, w), -1, np.int32)
            rows[0, : min(w, 2)] = [0, min(1, len(self.levels) - 1)]
            for cap_l in sorted(set(self.caps)):
                self._cap_reprune(vectors, vn, ids, rows, cap_l)

    def _union_rows(self, l: int, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Extract union rows for `ids` from the sorted key array (the
        stage-3 output of the full pass, grouped per node)."""
        keys = self.keys[l]
        if len(keys) == 0:
            return np.full((len(ids), 1), -1, np.int32), np.zeros(len(ids), np.int64)
        lo = np.searchsorted(keys, _keys_of(ids, np.zeros_like(ids)))
        hi = np.searchsorted(keys, _keys_of(ids + 1, np.zeros_like(ids)))
        counts = hi - lo
        # bucket the row width to a pow2 ladder: counts.max() varies per
        # update batch, and a fresh [B, w] prune_batch shape costs a remote
        # recompile (~1.4-1.9s per level per batch — the dominant warm-update
        # cost before this; the -1 pad lanes are masked out downstream)
        w = max(1, int(counts.max(initial=1)))
        w = max(64, 1 << (w - 1).bit_length())
        idx = lo[:, None] + np.arange(w)[None, :]
        valid = idx < hi[:, None]
        rows = np.where(
            valid,
            (keys[np.minimum(idx, len(keys) - 1)] & ((np.int64(1) << _SHIFT) - 1)),
            -1,
        ).astype(np.int32)
        return rows, counts

    def _stages45(self, l: int, ids: np.ndarray, vectors, vn) -> np.ndarray:
        """Union rows -> cap re-prune -> hierarchical level filter; returns
        final rows [len(ids), cap_l] (canonical ascending, -1 padded)."""
        from .prune import _sort_row_ids

        cap_l = self.caps[l]
        rows, counts = self._union_rows(l, ids)
        if rows.shape[1] < cap_l:
            rows = np.pad(rows, ((0, 0), (0, cap_l - rows.shape[1])),
                          constant_values=-1)
        over = np.nonzero(counts > cap_l)[0]
        out = np.full((len(ids), cap_l), -1, np.int32)
        under = counts <= cap_l
        out[under] = rows[under, :cap_l]
        if len(over):
            out[over] = self._cap_reprune(
                vectors, vn, ids[over], rows[over], cap_l
            )
        if l != self.cfg.threshold_level:
            keep = (out >= 0) & (self.levels[np.maximum(out, 0)] == l)
            out = _sort_row_ids(np.where(keep, out, -1))
        return out

    # ---- full conversion -------------------------------------------------

    def full(self, adj_np: list[np.ndarray], levels: np.ndarray, entry: int,
             vectors, vn, verbose: bool = False) -> ChalGraph:
        """Initial convertFromHNSW (hnswalg_slim.h:867-1108), capturing the
        per-level state the update path needs."""
        import os
        import time as _time

        from .prune import degree_thresholds

        timing = verbose or os.environ.get("SLIM_TIMING")
        tmarks: list[tuple[str, float]] = []
        tick = _time.perf_counter

        self.levels = np.asarray(levels, np.int32).copy()
        n = len(self.levels)
        self.entry = int(entry)
        self.lmax = len(adj_np) - 1
        maxM0 = adj_np[0].shape[1]
        maxM = adj_np[1].shape[1] if self.lmax >= 1 else maxM0 // 2
        self.caps = [maxM0] + [maxM] * self.lmax
        self.out_ws = [self.cfg.top_M0] + [self.cfg.top_M] * self.lmax
        self.thr = degree_thresholds(
            adj_np, self.levels, maxM0, self.cfg, self.count_level0_hubs
        )
        self.budgets, self.stage2, self.keys, self.final = [], [], [], []

        for l in range(self.lmax + 1):
            t0 = tick()
            act = np.nonzero(self.levels >= l)[0]
            a = adj_np[l][act]
            deg = (a >= 0).sum(axis=1)
            hi, lo = (
                (self.cfg.top_M0, self.cfg.low_m0) if l == 0
                else (self.cfg.top_M, self.cfg.low_m)
            )
            out_w = self.out_ws[l]
            budget_act = np.where(deg > self.thr[l], hi, lo)
            budgets = np.zeros(n, np.int32)
            budgets[act] = budget_act
            self.budgets.append(budgets)

            pruned = self._stage2_prune(
                vectors, vn, act, a, budget_act, out_w
            )
            if timing:
                tmarks.append((f"L{l}.stage2", tick() - t0))
                t0 = tick()
            s2 = np.full((n, out_w), -1, np.int32)
            s2[act] = pruned
            self.stage2.append(s2)

            src, tgt = _row_edges(pruned, act)
            keys = np.unique(
                np.concatenate([_keys_of(src, tgt), _keys_of(tgt, src)])
            )
            self.keys.append(keys)
            if timing:
                tmarks.append((f"L{l}.keys", tick() - t0))
                t0 = tick()

            fin = np.full((n, self.caps[l]), -1, np.int32)
            fin[act] = self._stages45(l, act, vectors, vn)
            if timing:
                tmarks.append((f"L{l}.stages45", tick() - t0))
                t0 = tick()
            if l == self.cfg.threshold_level:
                pre = fin[act].copy()
                fin[act] = self._repair(fin[act], act, vectors, vn)
                self.repair_keys = _added_keys(pre, fin[act], act)
                if timing:
                    tmarks.append((f"L{l}.repair", tick() - t0))
            self.final.append(fin)
            if verbose:
                print(f"  inc level {l}: thr={self.thr[l]} "
                      f"edges={(fin >= 0).sum()}")

        if timing:
            print("  full timing: " + " ".join(
                f"{k}={v:.2f}s" for k, v in tmarks if v >= 0.05
            ), flush=True)
        return self._pack()

    # ---- incremental update ----------------------------------------------

    def update(self, adj_np: list[np.ndarray], levels: np.ndarray, entry: int,
               vectors, vn, touched: np.ndarray,
               level_changed: np.ndarray | None = None,
               verbose: bool = False,
               device_pack: bool = True) -> tuple[ChalGraph, np.ndarray]:
        """Re-prune after `touched` vanilla rows changed (inserted nodes +
        reverse-connect targets). `level_changed`: nodes whose element level
        changed (slot reuse resamples levels) — their in-neighbors' stage-5
        membership filters are re-evaluated. Returns (graph, changed_node_ids)
        where changed ids are exactly the nodes whose final CHAL content
        differs — the patch membership set (hnswalg_slim.h:1360-1382)."""
        import os
        import time

        from .prune import degree_thresholds

        timing = verbose or os.environ.get("SLIM_TIMING")
        tmarks: list[tuple[str, float]] = []
        tick = time.perf_counter

        n_old = len(self.levels)
        levels = np.asarray(levels, np.int32)
        n = len(levels)
        self.entry = int(entry)
        lmax_new = len(adj_np) - 1
        if lmax_new > self.lmax:  # a new top level appeared (rare)
            for l in range(self.lmax + 1, lmax_new + 1):
                self.caps.append(adj_np[l].shape[1])
                self.out_ws.append(self.cfg.top_M)
                self.budgets.append(np.zeros(n_old, np.int32))
                self.stage2.append(np.full((n_old, self.cfg.top_M), -1, np.int32))
                self.keys.append(np.zeros(0, np.int64))
                self.final.append(np.full((n_old, self.caps[l]), -1, np.int32))
            self.lmax = lmax_new
        if n > n_old:
            grow = lambda a, w: np.concatenate(
                [a, np.full((n - n_old, w), -1, a.dtype)]
            ) if a.ndim == 2 else np.concatenate(
                [a, np.zeros(n - n_old, a.dtype)]
            )
            self.budgets = [grow(b, 0) for b in self.budgets]
            self.stage2 = [grow(s, s.shape[1]) for s in self.stage2]
            self.final = [grow(f, f.shape[1]) for f in self.final]
        self.levels = levels.copy()

        touched = np.unique(np.asarray(touched, np.int64))
        maxM0 = adj_np[0].shape[1]
        thr = degree_thresholds(
            adj_np, levels, maxM0, self.cfg, self.count_level0_hubs
        )
        changed_all: list[np.ndarray] = []

        for l in range(self.lmax + 1):
            t0 = tick()
            act_mask = levels >= l
            hi, lo = (
                (self.cfg.top_M0, self.cfg.low_m0) if l == 0
                else (self.cfg.top_M, self.cfg.low_m)
            )
            deg_all = (adj_np[l] >= 0).sum(axis=1)
            budgets_new = np.where(
                act_mask, np.where(deg_all > thr[l], hi, lo), 0
            ).astype(np.int32)

            # stage-2 set: touched rows + budget flips (threshold drift,
            # level deactivation via slot reuse -> budget 0)
            c2_mask = np.zeros(n, bool)
            c2_mask[touched] = True
            c2_mask |= budgets_new != self.budgets[l]
            c2 = np.nonzero(c2_mask)[0]
            self.budgets[l] = budgets_new

            act_c2 = c2[act_mask[c2]]
            old_rows = self.stage2[l][c2]
            new_rows = np.full((len(c2), self.out_ws[l]), -1, np.int32)
            new_rows[act_mask[c2]] = self._stage2_prune(
                vectors, vn, act_c2, adj_np[l][act_c2],
                budgets_new[act_c2], self.out_ws[l],
            )
            self.stage2[l][c2] = new_rows
            tmarks.append((f"L{l}.stage2[{len(act_c2)}]", tick() - t0))
            t0 = tick()

            # stage-3 delta: every pair whose directed membership may flip
            os, ot = _row_edges(old_rows, c2)
            ns, nt = _row_edges(new_rows, c2)
            pair_u = np.concatenate([os, ot, ns, nt])
            pair_v = np.concatenate([ot, os, nt, ns])
            if len(pair_u):
                cand = np.unique(_keys_of(pair_u, pair_v))
                cu = (cand >> _SHIFT).astype(np.int64)
                cv = (cand & ((np.int64(1) << _SHIFT) - 1)).astype(np.int64)
                # key (u,v) exists iff v in stage2[u] or u in stage2[v]
                want = (
                    (self.stage2[l][cu] == cv[:, None]).any(axis=1)
                    | (self.stage2[l][cv] == cu[:, None]).any(axis=1)
                )
                pos = np.searchsorted(self.keys[l], cand)
                have = np.zeros(len(cand), bool)
                inb = pos < len(self.keys[l])
                have[inb] = self.keys[l][pos[inb]] == cand[inb]
                flip = want != have
                t_sm = time.perf_counter()
                self.keys[l] = _sorted_merge(
                    self.keys[l], cand[flip & want], cand[flip & ~want]
                )
                if timing:
                    tmarks.append(
                        (f"L{l}.keys.merge", time.perf_counter() - t_sm))
                affected_src = cu[flip]
            else:
                affected_src = np.zeros(0, np.int64)

            # stage-5 membership depends on neighbor LEVELS: in-neighbors of
            # level-changed nodes must re-filter even if their union is intact
            lvl_extra = np.zeros(0, np.int64)
            if (level_changed is not None and len(level_changed)
                    and l != self.cfg.threshold_level and len(self.keys[l])):
                tgts = self.keys[l] & ((np.int64(1) << _SHIFT) - 1)
                hitk = np.isin(tgts, level_changed)
                lvl_extra = (self.keys[l][hitk] >> _SHIFT).astype(np.int64)

            tmarks.append((f"L{l}.keys", tick() - t0))
            t0 = tick()
            # repair-edge bookkeeping: drop bridges with a deactivated
            # endpoint (their src rows must be rebuilt to shed the stale id)
            rep_extra = np.zeros(0, np.int64)
            if l == self.cfg.threshold_level and len(self.repair_keys):
                rs = (self.repair_keys >> _SHIFT).astype(np.int64)
                rt = (self.repair_keys & ((np.int64(1) << _SHIFT) - 1)).astype(np.int64)
                alive = act_mask[rs] & act_mask[rt]
                rep_extra = np.unique(rs[~alive])
                self.repair_keys = self.repair_keys[alive]
            # stage-4/5 working set: rows whose UNION actually changed (the
            # key-delta's flipped sources), not all of c2 — a touched row
            # whose stage-2 output re-pruned to the same edges has an intact
            # union and (deterministic stages) an intact final row. On
            # in-distribution 1000-vector batches at 1M this cuts the
            # stages45 set ~65k -> the true-delta subset.
            # Inactive c2 rows still pass through for the deact-clear path:
            # a node can deactivate without any key flipping (its reverse
            # membership in others' stage-2 rows keeps the keys alive).
            c2_inact = c2[~act_mask[c2]]
            a_all = np.unique(
                np.concatenate([c2_inact, affected_src, lvl_extra, rep_extra])
            )
            a_ids = a_all[act_mask[a_all]]
            deact = a_all[~act_mask[a_all]]
            changed_l = []
            if len(deact):  # level dropped: clear rows, mark changed
                had = (self.final[l][deact] >= 0).any(axis=1)
                self.final[l][deact] = -1
                changed_l.append(deact[had])
            if len(a_ids) == 0:
                changed_all.append(
                    np.concatenate(changed_l) if changed_l
                    else np.zeros(0, np.int64)
                )
                continue
            new_final = self._stages45(l, a_ids, vectors, vn)
            if l == self.cfg.threshold_level and len(self.repair_keys):
                # stage 4/5 rebuilt these rows from the union, which never
                # contained the repair bridges — re-apply them (ADVICE r2)
                rs = (self.repair_keys >> _SHIFT).astype(np.int64)
                rt = (self.repair_keys & ((np.int64(1) << _SHIFT) - 1)).astype(np.int64)
                lookup = np.full(n, -1, np.int64)
                lookup[a_ids] = np.arange(len(a_ids))
                li = lookup[rs]
                hit = li >= 0
                for i, t in zip(li[hit], rt[hit]):  # bridges are few
                    row = new_final[i]
                    if t in row:
                        continue
                    empty = np.nonzero(row < 0)[0]
                    row[empty[0] if len(empty) else -1] = t
            prev = self.final[l][a_ids]
            w = max(prev.shape[1], new_final.shape[1])
            changed_rows = (
                np.pad(prev, ((0, 0), (0, w - prev.shape[1])),
                       constant_values=-1)
                != np.pad(new_final, ((0, 0), (0, w - new_final.shape[1])),
                          constant_values=-1)
            ).any(axis=1)
            self.final[l][a_ids] = new_final
            tmarks.append((f"L{l}.stages45[{len(a_ids)}]", tick() - t0))
            t0 = tick()

            changed_l.append(a_ids[changed_rows])
            if l == self.cfg.threshold_level and self.repair_updates:
                act = np.nonzero(act_mask)[0]
                repaired = self._repair(
                    self.final[l][act], act, vectors, vn
                )
                rep_changed = (repaired != self.final[l][act]).any(axis=1)
                self.repair_keys = np.union1d(
                    self.repair_keys,
                    _added_keys(self.final[l][act], repaired, act),
                )
                self.final[l][act] = repaired
                changed_l.append(act[rep_changed])
                tmarks.append((f"L{l}.repair", tick() - t0))
            changed_all.append(np.unique(np.concatenate(changed_l)))
            if verbose:
                print(f"  inc-upd level {l}: c2={len(c2)} "
                      f"affected={len(a_ids)} changed={changed_rows.sum()}")

        changed = np.unique(np.concatenate(changed_all)) if changed_all else \
            np.zeros(0, np.int64)
        t0 = tick()
        out = self._pack(device=device_pack)
        if timing:
            tmarks.append(("pack", tick() - t0))
            print("  inc timing: " + " ".join(
                f"{k}={v:.2f}s" for k, v in tmarks if v >= 0.05
            ), flush=True)
        return out, changed

    # ---- helpers -----------------------------------------------------------

    def _repair(self, rows: np.ndarray, act: np.ndarray, vectors, vn):
        from .build import repair_connectivity

        return repair_connectivity(
            rows, act.astype(np.int32), vectors, vn, self.metric
        )

    def _pack(self, device: bool = True) -> ChalGraph:
        from .prune import pack_chal_arrays

        out = pack_chal_arrays(
            self.final, self.levels,
            entry=self.entry,
            max_level=self.lmax,
            threshold_level=self.cfg.threshold_level,
            cap0=self.caps[0],
            cap=self.caps[1] if self.lmax >= 1 else self.caps[0] // 2,
            return_host=True,
            device=device,
        )
        graph, self.host_chal = out  # host mirror: patch/persist paths read
        # it directly instead of pulling the device arrays back (D2H of
        # ~100 MB/update at 1M)
        return graph


class IncrementalSlimZero:
    """Stateful SlimZero conversion: full() once, then update(touched).

    Counterpart of convertFromHNSWWithDiff
    (hnswalg_slimzero.h:1590-1660). Like the reference — whose shared
    in-degree counters carry across calls — the incremental pass re-prunes
    touched rows against the LIVE in-degrees of the CURRENT serving graph,
    so the result is invariant-equivalent (floor + cap + hierarchy hold
    after every update) rather than byte-identical to a fresh full pass.
    Floor starvation introduced by a delta is repaired by re-adding donor
    in-edges exactly as the full pass does (graph/prune.py floor repair).
    """

    def __init__(self, cfg: SlimConfig, metric: str = "l2",
                 count_level0_hubs: bool = False, chunk: int = 2048):
        self.cfg = cfg
        self.metric = metric
        self.count_level0_hubs = count_level0_hubs
        self.chunk = chunk
        self.final: list[np.ndarray] = []
        self.budgets: list[np.ndarray] = []
        self.thr: np.ndarray | None = None
        self.levels: np.ndarray | None = None
        self.entry = 0
        self.lmax = 0
        self.caps: list[int] = []

    # ---- full conversion -------------------------------------------------

    def full(self, adj_np: list[np.ndarray], levels: np.ndarray, entry: int,
             vectors, vn, verbose: bool = False) -> ChalGraph:
        from .types import LevelGraph
        from .prune import convert_to_slimzero

        import jax.numpy as jnp

        lg = LevelGraph(
            adjs=[jnp.asarray(a) for a in adj_np],
            level=jnp.asarray(levels),
            entry=jnp.asarray(entry),
            max_level=len(adj_np) - 1,
        )
        st: dict = {}
        graph = convert_to_slimzero(
            lg, vectors, vn, self.cfg, metric=self.metric,
            count_level0_hubs=self.count_level0_hubs, chunk=self.chunk,
            verbose=verbose, state=st,
        )
        self.final = st["final"]
        self.budgets = st["budgets"]
        self.thr = st["thr"]
        self.levels = np.asarray(levels, np.int32).copy()
        self.entry = int(entry)
        self.lmax = st["lmax"]
        self.caps = st["caps"]
        # re-pack through _pack so host_chal exists for the patch path
        return self._pack()

    # ---- incremental update ----------------------------------------------

    def update(self, adj_np: list[np.ndarray], levels: np.ndarray, entry: int,
               vectors, vn, touched: np.ndarray,
               level_changed: np.ndarray | None = None,
               verbose: bool = False,
               device_pack: bool = True) -> tuple[ChalGraph, np.ndarray]:
        """Re-prune after `touched` vanilla rows changed. Returns
        (graph, changed_node_ids) — ids whose final CHAL content differs
        (the patch membership set)."""
        import jax.numpy as jnp

        from .heuristic import prune_batch_guarded
        from .prune import _pad, _sort_row_ids, degree_thresholds

        n_old = len(self.levels)
        levels = np.asarray(levels, np.int32)
        n = len(levels)
        self.entry = int(entry)
        lmax_new = len(adj_np) - 1
        if lmax_new > self.lmax:
            for l in range(self.lmax + 1, lmax_new + 1):
                self.caps.append(adj_np[l].shape[1])
                self.final.append(
                    np.full((n_old, self.caps[l]), -1, np.int32))
                self.budgets.append(np.zeros(n_old, np.int32))
            self.lmax = lmax_new
        if n > n_old:
            self.final = [
                np.concatenate(
                    [f, np.full((n - n_old, f.shape[1]), -1, np.int32)])
                for f in self.final
            ]
            self.budgets = [
                np.concatenate([b, np.zeros(n - n_old, np.int32)])
                for b in self.budgets
            ]
        self.levels = levels.copy()

        touched = np.unique(np.asarray(touched, np.int64))
        maxM0 = adj_np[0].shape[1]
        self.thr = degree_thresholds(
            adj_np, levels, maxM0, self.cfg, self.count_level0_hubs
        )
        changed_all: list[np.ndarray] = []

        for l in range(self.lmax + 1):
            act_mask = levels >= l
            hi, lo = (
                (self.cfg.top_M0, self.cfg.low_m0) if l == 0
                else (self.cfg.top_M, self.cfg.low_m)
            )
            m_rev = (self.cfg.min_indegree0 if l == 0
                     else self.cfg.min_indegree)
            cap_l = self.caps[l]
            deg_all = (adj_np[l] >= 0).sum(axis=1)
            budgets_new = np.where(
                act_mask, np.where(deg_all > self.thr[l], hi, lo), 0
            ).astype(np.int32)

            r_mask = np.zeros(n, bool)
            r_mask[touched] = True
            r_mask |= budgets_new != self.budgets[l]
            if level_changed is not None and len(level_changed):
                r_mask[np.asarray(level_changed, np.int64)] = True
            r_all = np.nonzero(r_mask)[0]
            self.budgets[l] = budgets_new

            changed_l: list[np.ndarray] = []
            deact = r_all[~act_mask[r_all]]
            if len(deact):
                had = (self.final[l][deact] >= 0).any(axis=1)
                self.final[l][deact] = -1
                changed_l.append(deact[had])
            r = r_all[act_mask[r_all]]
            if len(r) == 0:
                changed_all.append(
                    np.concatenate(changed_l) if changed_l
                    else np.zeros(0, np.int64)
                )
                continue

            fin = self.final[l]
            live = np.bincount(
                fin.reshape(-1)[fin.reshape(-1) >= 0], minlength=n
            )
            old_rows = fin[r].copy()
            a_r = adj_np[l][r]
            guard = live[np.maximum(a_r, 0)] <= m_rev
            w_in = a_r.shape[1]
            rows = np.full((len(r), w_in), -1, np.int32)
            for s in range(0, len(r), self.chunk):
                ck = slice(s, min(s + self.chunk, len(r)))
                cpad = _pad(a_r[ck])
                sel, _ = prune_batch_guarded(
                    vectors, vn,
                    jnp.asarray(_pad(r[ck], fill=0)),
                    jnp.asarray(cpad),
                    jnp.asarray(cpad >= 0),
                    jnp.asarray(
                        _pad(guard[ck].astype(np.int8), fill=0).astype(bool)),
                    M=w_in, metric=self.metric, out_width=w_in,
                    m_per_row=jnp.asarray(
                        _pad(budgets_new[r[ck]], fill=1)),
                )
                rows[ck] = np.asarray(sel)[: ck.stop - ck.start]

            # cap + hierarchical filter on the recomputed rows
            rows = self._cap_filter(l, r, rows, vectors, vn, cap_l, levels)
            diff = (old_rows != rows).any(axis=1)
            self.final[l][r] = rows
            changed_l.append(r[diff])

            # delta in-degree -> floor repair (graph/prune.py invariant:
            # active nodes keep in-degree >= m_rev where donors exist). At
            # non-threshold levels only exactly-level-l nodes can survive
            # the hierarchy filter in a donor row, so only those repair.
            live2 = live.copy()
            for arr, sign in ((old_rows, -1), (rows, +1)):
                v = arr.reshape(-1)
                v = v[v >= 0]
                if len(v):
                    live2 += sign * np.bincount(v, minlength=n)
            s_mask = (live2 < m_rev) & act_mask
            if l != self.cfg.threshold_level:
                s_mask &= levels == l
            starved = np.nonzero(s_mask)[0]
            if len(starved):
                changed_l.append(
                    self._floor_repair(l, starved, live2, adj_np[l],
                                       act_mask, m_rev))
            changed_all.append(np.unique(np.concatenate(changed_l)))
            if verbose:
                print(f"  zinc-upd level {l}: r={len(r)} "
                      f"changed={int(diff.sum())} starved={len(starved)}")

        changed = np.unique(np.concatenate(changed_all)) if changed_all else \
            np.zeros(0, np.int64)
        return self._pack(device=device_pack), changed

    # ---- helpers -----------------------------------------------------------

    def _cap_filter(self, l, ids, rows, vectors, vn, cap_l, levels):
        """Cap re-prune + hierarchical level filter (full-pass stages on the
        recomputed subset)."""
        import jax.numpy as jnp

        from .heuristic import prune_batch
        from .prune import _pad, _sort_row_ids

        counts = (rows >= 0).sum(axis=1)
        out = np.full((len(ids), cap_l), -1, np.int32)
        under = counts <= cap_l
        w = min(cap_l, rows.shape[1])
        out[under, :w] = _sort_row_ids(rows[under])[:, :w]
        over = np.nonzero(~under)[0]
        if len(over):
            for s in range(0, len(over), self.chunk):
                ck = slice(s, min(s + self.chunk, len(over)))
                cpad = _pad(rows[over][ck])
                sel, _ = prune_batch(
                    vectors, vn,
                    jnp.asarray(_pad(ids[over][ck], fill=0)),
                    jnp.asarray(cpad),
                    jnp.asarray(cpad >= 0),
                    M=cap_l, keep_all_under_m=False, metric=self.metric,
                    out_width=cap_l,
                )
                out[over[ck]] = _sort_row_ids(
                    np.asarray(sel)[: ck.stop - ck.start]
                )
        if l != self.cfg.threshold_level:
            keep = (out >= 0) & (levels[np.maximum(out, 0)] == l)
            out = _sort_row_ids(np.where(keep, out, -1))
        return out

    def _floor_repair(self, l, starved, live, adj_l, act_mask,
                      m_rev) -> np.ndarray:
        """Re-add donor in-edges for nodes whose in-degree fell below the
        floor; donors = vanilla rows containing the starved node (stable
        lowest-id order, free slots only). Returns modified donor ids."""
        fin = self.final[l]
        act = np.nonzero(act_mask)[0]
        a = adj_l[act]
        # restrict the donor scan to rows that mention a starved node
        # (np.isin over the level's edges; starved sets are tiny)
        hit = np.isin(a, starved) & (a >= 0)
        rsel = np.nonzero(hit.any(axis=1))[0]
        a, hit = a[rsel], hit[rsel]
        tgts = a[hit].astype(np.int64)
        srcs = np.repeat(act[rsel], hit.sum(axis=1)).astype(np.int64)
        order = np.argsort(tgts, kind="stable")
        ts, rs = tgts[order], srcs[order]
        modified: list[int] = []
        for u in starved:
            lo = np.searchsorted(ts, u)
            hi = np.searchsorted(ts, u, side="right")
            need = int(m_rev - live[u])
            for d in rs[lo:hi]:
                if need <= 0:
                    break
                row = fin[d]
                if (row == u).any():
                    continue
                free = np.nonzero(row < 0)[0]
                if not len(free):
                    continue
                row[free[0]] = u
                fin[d] = np.sort(np.where(row < 0, np.iinfo(np.int32).max,
                                          row))
                fin[d][fin[d] == np.iinfo(np.int32).max] = -1
                live[u] += 1
                need -= 1
                modified.append(int(d))
        return np.asarray(sorted(set(modified)), np.int64)

    def _pack(self, device: bool = True) -> ChalGraph:
        from .prune import pack_chal_arrays

        out = pack_chal_arrays(
            self.final, self.levels,
            entry=self.entry,
            max_level=self.lmax,
            threshold_level=self.cfg.threshold_level,
            cap0=self.caps[0],
            cap=self.caps[1] if self.lmax >= 1 else self.caps[0] // 2,
            return_host=True,
            device=device,
        )
        graph, self.host_chal = out
        return graph

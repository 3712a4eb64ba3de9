"""De Bruijn graph consensus haplotypes for local read realignment.

Clean-room counterpart of the reference's DeepVariant-derived
``debruijn_graph.cpp`` (boost::adjacency_list): build a k-mer graph from
window reads (+ the reference to guarantee a source->sink path), prune
low-support edges, and enumerate bounded ref-anchored paths as candidate
haplotype sequences.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_K_RANGE = (15, 19, 23, 27, 31)
MAX_HAPLOTYPES = 128


def _kmer_edges(seq: str, k: int, weight: int, edges: Dict[str, Dict[str, int]]) -> None:
    for i in range(len(seq) - k):
        u = seq[i: i + k]
        v = seq[i + 1: i + 1 + k]
        if "N" in u or "N" in v:
            continue
        edges[u][v] = edges[u].get(v, 0) + weight


def _is_acyclic_from(source: str, edges: Dict[str, Dict[str, int]]) -> bool:
    """DFS cycle check over the subgraph reachable from source."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = defaultdict(int)
    stack: List[Tuple[str, Optional[iter]]] = [(source, None)]
    # iterative DFS with colors
    path: List[str] = []
    iters: Dict[str, List[str]] = {}
    stack = [source]
    while stack:
        node = stack[-1]
        if color[node] == 0:
            color[node] = GRAY
            iters[node] = list(edges.get(node, {}))
        nxt = None
        while iters[node]:
            cand = iters[node].pop()
            if color[cand] == GRAY:
                return False
            if color[cand] == 0:
                nxt = cand
                break
        if nxt is None:
            color[node] = BLACK
            stack.pop()
        else:
            stack.append(nxt)
    return True


_native_checked = False
_native_fn = None


def _get_native():
    global _native_checked, _native_fn
    if _native_checked:
        return _native_fn
    _native_checked = True
    try:
        from clair3_tpu_torch.native import dbg_consensus_native, get_lib

        get_lib()  # compile eagerly so failures fall back once, not per call
        _native_fn = dbg_consensus_native
    except Exception:
        _native_fn = None
    return _native_fn


def consensus_haplotypes(
    reads: Sequence[str],
    ref_window: str,
    k_range: Sequence[int] = DEFAULT_K_RANGE,
    min_edge_weight: int = 2,
    max_haplotypes: int = MAX_HAPLOTYPES,
    use_native: Optional[bool] = None,
) -> List[str]:
    """Candidate haplotype sequences spanning ``ref_window``.

    Tries increasing k until the pruned graph reachable from the reference
    source k-mer is acyclic (the DeepVariant strategy).  The reference
    sequence contributes weight ``min_edge_weight`` so a ref path always
    survives pruning.  Returns haplotypes (always including the reference
    window), capped at ``max_haplotypes``.

    The C++ fast path (clair3t_dbg.cc, 2-bit packed k-mers) is used when
    available and every k <= 31; results are set-identical to this Python
    implementation (differential-tested), though path order may differ.
    """
    if use_native is None:
        fn = _get_native()
    elif use_native:
        fn = _get_native()
        if fn is None:
            raise RuntimeError("native DBG unavailable")
    else:
        fn = None
    if fn is not None and max(k_range, default=0) <= 31:
        haps = fn(reads, ref_window, k_range, min_edge_weight, max_haplotypes)
        if haps is not None:
            return haps
    for k in k_range:
        if len(ref_window) <= k:
            break
        edges: Dict[str, Dict[str, int]] = defaultdict(dict)
        _kmer_edges(ref_window, k, min_edge_weight, edges)
        for seq in reads:
            _kmer_edges(seq, k, 1, edges)
        # prune
        pruned: Dict[str, Dict[str, int]] = {}
        for u, outs in edges.items():
            kept = {v: w for v, w in outs.items() if w >= min_edge_weight}
            if kept:
                pruned[u] = kept
        source = ref_window[:k]
        sink = ref_window[-k:]
        if "N" in source or "N" in sink:
            break
        if not _is_acyclic_from(source, pruned):
            continue

        # enumerate source->sink paths (bounded)
        haplotypes: List[str] = []
        max_len = len(ref_window) + 64
        stack: List[Tuple[str, str]] = [(source, source)]
        truncated = False
        while stack:
            node, seq = stack.pop()
            if len(seq) > max_len:
                continue
            if node == sink and len(seq) >= k:
                haplotypes.append(seq)
                if len(haplotypes) >= max_haplotypes:
                    truncated = True
                    break
                continue
            for v in pruned.get(node, {}):
                stack.append((v, seq + v[-1]))
        if truncated:
            continue  # too tangled at this k; try larger
        if ref_window not in haplotypes:
            haplotypes.append(ref_window)
        return haplotypes
    return [ref_window]

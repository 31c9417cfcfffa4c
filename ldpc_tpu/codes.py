"""LDPC code representation for batched accelerator decoding.

Capability parity with the reference's ``LDPCCode`` (reference:
``ldpc_decoder.py:26-54``) — (n, k, H, max_iterations), rate, per-node degree
maps — but designed around a *static edge list* instead of a dense H matrix so
decoding maps onto XLA/Pallas as pure gathers over padded slot tables:

- every edge e of the Tanner graph gets an integer id;
- ``cn_slots[m, max_dc]`` / ``vn_slots[n, max_dv]`` hold edge ids padded with
  the sentinel ``num_edges`` (so ``concat(x, pad)`` gathers are mask-free);
- per-edge degree-bucket indices replace the reference's string-keyed
  ``nn.ParameterDict`` lookups (reference: ``neural_2d_decoder.py:84-131``)
  with dense ``weights[T, n_buckets]`` array indexing.

All arrays here are host-side numpy (int32) and static — they are closed over
by jitted decoders, never traced.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "LDPCCode",
    "DecoderGraph",
    "build_graph",
    "create_test_ldpc_code",
    "create_random_regular_code",
    "create_peg_code",
    "create_qc_code",
    "create_tanner_155",
    "tanner_155_base",
    "create_array_code",
    "gf2_rank",
    "create_dvbs2_like_code",
    "create_pbrl_like_code",
    "load_alist",
    "save_alist",
]


@dataclasses.dataclass
class LDPCCode:
    """An LDPC code: parity-check matrix plus decoding metadata.

    Mirrors the reference ``LDPCCode`` dataclass (``ldpc_decoder.py:26-54``)
    field-for-field so user code ports directly; adds a cached sparse edge
    list (the thing the batched decoders actually consume).
    """

    n: int
    k: int
    H: np.ndarray  # dense {0,1} uint8 [m, n]; kept for API parity & small codes
    max_iterations: int = 50

    def __post_init__(self) -> None:
        self.H = np.asarray(self.H, dtype=np.uint8)
        m, n = self.H.shape
        if n != self.n:
            raise ValueError(f"H has {n} columns, expected n={self.n}")
        self.m = m

    @property
    def rate(self) -> float:
        """Code rate k/n (reference ``ldpc_decoder.py:34-36``)."""
        return self.k / self.n

    @property
    def check_node_degrees(self) -> Dict[int, int]:
        """Row sums of H, per check node (reference ``ldpc_decoder.py:38-45``)."""
        deg = self.H.sum(axis=1)
        return {i: int(deg[i]) for i in range(self.H.shape[0])}

    @property
    def variable_node_degrees(self) -> Dict[int, int]:
        """Column sums of H, per variable node (reference ``ldpc_decoder.py:47-54``)."""
        deg = self.H.sum(axis=0)
        return {j: int(deg[j]) for j in range(self.H.shape[1])}

    @property
    def num_edges(self) -> int:
        return int(self.H.sum())


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash, so
# a graph instance can be a static jit argument (numpy fields are unhashable)
class DecoderGraph:
    """Static, padded edge-list view of a code's Tanner graph.

    Everything a jitted decoder needs, precomputed once on host:

    - ``edge_var[E]`` / ``edge_check[E]``: endpoints of each edge
      (edges ordered by (check, var), i.e. row-major over H).
    - ``cn_slots[m, max_dc]``: edge ids per check, padded with E.
    - ``edge_cn_slot[E]``: flat index of each edge inside ``cn_slots``
      (so scattering CN outputs back to edge order is a pure gather).
    - ``vn_slots[n, max_dv]``: edge ids per variable, padded with E.
    - ``cn_var_slots[m, max_dc]``: variable ids per CN slot, padded with n
      (for syndrome computation via gather of an n+1-long bit vector).
    - degree-bucket tables for weight sharing types 1-4 (reference
      ``neural_2d_decoder.py:46-131``): bucket universes are the *cartesian
      product* of unique degrees — matching the reference's parameter count
      exactly (it allocates weights for every (dc, dv) combo, present or not).
    """

    n: int
    m: int
    num_edges: int
    max_dc: int
    max_dv: int

    edge_var: np.ndarray  # [E] int32
    edge_check: np.ndarray  # [E] int32

    cn_slots: np.ndarray  # [m, max_dc] int32, pad = E
    cn_mask: np.ndarray  # [m, max_dc] bool
    edge_cn_slot: np.ndarray  # [E] int32 into flattened cn_slots
    cn_var_slots: np.ndarray  # [m, max_dc] int32, pad = n

    vn_slots: np.ndarray  # [n, max_dv] int32, pad = E
    vn_mask: np.ndarray  # [n, max_dv] bool

    # degree metadata
    check_degree: np.ndarray  # [m] int32
    var_degree: np.ndarray  # [n] int32
    unique_dc: Tuple[int, ...]  # sorted unique check degrees (excluding 0)
    unique_dv: Tuple[int, ...]  # sorted unique variable degrees (excluding 0)

    # per-edge degree-bucket indices
    edge_dc_bucket: np.ndarray  # [E] int32 into unique_dc
    edge_dv_bucket: np.ndarray  # [E] int32 into unique_dv
    edge_dcdv_bucket: np.ndarray  # [E] int32 into unique_dc x unique_dv


def build_graph(code: LDPCCode) -> DecoderGraph:
    """Precompute the padded edge-list tables for a code (host-side)."""
    H = code.H
    m, n = H.shape
    checks, vars_ = np.nonzero(H)  # row-major: sorted by (check, var)
    E = checks.shape[0]
    edge_check = checks.astype(np.int32)
    edge_var = vars_.astype(np.int32)

    check_degree = H.sum(axis=1).astype(np.int32)
    var_degree = H.sum(axis=0).astype(np.int32)
    max_dc = int(check_degree.max())
    max_dv = int(var_degree.max())

    cn_slots = np.full((m, max_dc), E, dtype=np.int32)
    cn_var_slots = np.full((m, max_dc), n, dtype=np.int32)
    edge_cn_slot = np.zeros(E, dtype=np.int32)
    fill = np.zeros(m, dtype=np.int32)
    for e in range(E):
        c = edge_check[e]
        s = fill[c]
        cn_slots[c, s] = e
        cn_var_slots[c, s] = edge_var[e]
        edge_cn_slot[e] = c * max_dc + s
        fill[c] = s + 1
    cn_mask = cn_slots != E

    vn_slots = np.full((n, max_dv), E, dtype=np.int32)
    fill = np.zeros(n, dtype=np.int32)
    for e in range(E):
        v = edge_var[e]
        vn_slots[v, fill[v]] = e
        fill[v] = fill[v] + 1
    vn_mask = vn_slots != E

    unique_dc = tuple(sorted(int(d) for d in np.unique(check_degree[check_degree > 0])))
    unique_dv = tuple(sorted(int(d) for d in np.unique(var_degree[var_degree > 0])))
    dc_to_bucket = {d: i for i, d in enumerate(unique_dc)}
    dv_to_bucket = {d: i for i, d in enumerate(unique_dv)}

    edge_dc_bucket = np.array(
        [dc_to_bucket[int(check_degree[c])] for c in edge_check], dtype=np.int32
    )
    edge_dv_bucket = np.array(
        [dv_to_bucket[int(var_degree[v])] for v in edge_var], dtype=np.int32
    )
    # pair bucket over the full cartesian product (matches reference's
    # parameter universe, neural_2d_decoder.py:50-54)
    edge_dcdv_bucket = (edge_dc_bucket * len(unique_dv) + edge_dv_bucket).astype(
        np.int32
    )

    return DecoderGraph(
        n=n,
        m=m,
        num_edges=E,
        max_dc=max_dc,
        max_dv=max_dv,
        edge_var=edge_var,
        edge_check=edge_check,
        cn_slots=cn_slots,
        cn_mask=cn_mask,
        edge_cn_slot=edge_cn_slot,
        cn_var_slots=cn_var_slots,
        vn_slots=vn_slots,
        vn_mask=vn_mask,
        check_degree=check_degree,
        var_degree=var_degree,
        unique_dc=unique_dc,
        unique_dv=unique_dv,
        edge_dc_bucket=edge_dc_bucket,
        edge_dv_bucket=edge_dv_bucket,
        edge_dcdv_bucket=edge_dcdv_bucket,
    )


# ---------------------------------------------------------------------------
# Code factories
# ---------------------------------------------------------------------------


def create_test_ldpc_code() -> LDPCCode:
    """The (7,4) test code — same H as the reference's universal fixture
    (``ldpc_decoder.py:274-284``): 13 edges, check degrees {3,3,3,4},
    variable degrees {1,3}, max_iterations=10."""
    H = np.array(
        [
            [1, 1, 0, 1, 0, 0, 0],
            [0, 1, 1, 0, 1, 0, 0],
            [1, 0, 1, 0, 0, 1, 0],
            [1, 1, 1, 0, 0, 0, 1],
        ],
        dtype=np.uint8,
    )
    return LDPCCode(n=7, k=4, H=H, max_iterations=10)


def create_random_regular_code(
    n: int,
    m: int,
    dv: int,
    seed: int = 0,
    max_iterations: int = 50,
) -> LDPCCode:
    """Random (dv, dc)-regular-ish Gallager construction.

    Column weight exactly ``dv``; row weights near ``n*dv/m``. Genuinely
    low-density — unlike the reference's fake "DVB-S2" generator which emits
    a ~50%-dense random matrix (``training_framework.py:379-400``, SURVEY §8.7).
    """
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), dtype=np.uint8)
    # permutation-based: stack dv permutations of a balanced assignment
    base = np.repeat(np.arange(m), int(np.ceil(n / m)))[:n]
    for _ in range(dv):
        rows = base[rng.permutation(n)]
        for j in range(n):
            r = rows[j]
            # avoid duplicate edge: linear probe to the next row
            tries = 0
            while H[r, j] == 1 and tries < m:
                r = (r + 1) % m
                tries += 1
            H[r, j] = 1
    # repair: every check needs degree >= 1 (mirrors the intent of
    # training_framework.py:392-397 but on a sparse matrix)
    for i in range(m):
        if H[i].sum() == 0:
            j = rng.integers(0, n)
            H[i, j] = 1
    return LDPCCode(n=n, k=n - m, H=H, max_iterations=max_iterations)


def create_peg_code(
    n: int,
    m: int,
    dv: int = 3,
    seed: int = 0,
    max_iterations: int = 50,
) -> LDPCCode:
    """Progressive Edge Growth construction (Hu, Eleftheriou, Arnold 2005).

    Greedy girth-maximizing: for each new edge of variable j, pick the check
    farthest from j in the current subgraph (or the lowest-degree unreached
    check). Produces codes with good waterfall behavior for testing at
    realistic block lengths — a real "large code" capability the reference
    lacks (its DVB-S2 factory is fake, SURVEY §8.7).
    """
    rng = np.random.default_rng(seed)
    adj_v = [[] for _ in range(n)]  # checks per variable
    adj_c = [[] for _ in range(m)]  # variables per check
    check_deg = np.zeros(m, dtype=np.int64)

    for j in range(n):
        for _ in range(dv):
            if not adj_v[j]:
                # first edge: lowest-degree check (ties broken randomly)
                cand = np.flatnonzero(check_deg == check_deg.min())
                c = int(rng.choice(cand))
            else:
                # BFS from variable j over the current bipartite graph;
                # remember the deepest frontier for the saturated case
                reached = np.zeros(m, dtype=bool)
                frontier_c = set(adj_v[j])
                for c0 in frontier_c:
                    reached[c0] = True
                deepest = set(frontier_c)
                depth = 0
                while depth < 64:
                    nxt_vars = set()
                    for c0 in frontier_c:
                        nxt_vars.update(adj_c[c0])
                    nxt_checks = set()
                    for v0 in nxt_vars:
                        for c0 in adj_v[v0]:
                            if not reached[c0]:
                                nxt_checks.add(c0)
                    if not nxt_checks:
                        break
                    for c0 in nxt_checks:
                        reached[c0] = True
                    deepest = nxt_checks
                    frontier_c = nxt_checks
                    depth += 1
                unreached = np.flatnonzero(~reached)
                if unreached.size:
                    pool = unreached
                else:
                    # everything reachable: PEG picks at maximum distance
                    pool = np.array(
                        sorted(deepest - set(adj_v[j])), dtype=np.int64)
                    if pool.size == 0:
                        pool = np.flatnonzero(
                            ~np.isin(np.arange(m), adj_v[j]))
                if pool.size == 0:
                    break
                deg_pool = check_deg[pool]
                cand = pool[deg_pool == deg_pool.min()]
                c = int(rng.choice(cand))
            adj_v[j].append(c)
            adj_c[c].append(j)
            check_deg[c] += 1

    H = np.zeros((m, n), dtype=np.uint8)
    for j in range(n):
        for c in adj_v[j]:
            H[c, j] = 1
    return LDPCCode(n=n, k=n - m, H=H, max_iterations=max_iterations)


def create_qc_code(
    base_matrix: np.ndarray,
    lift: int,
    max_iterations: int = 50,
) -> LDPCCode:
    """Quasi-cyclic lifting: expand a base/proto matrix by circulant shifts.

    ``base_matrix[i, j] = -1`` means a zero block; ``s >= 0`` means the
    ``lift x lift`` identity right-shifted by ``s``. This is the structure of
    the paper's (9472, 8192) QC code family (paper §VII-B); the reference has
    no QC support at all.
    """
    B = np.asarray(base_matrix, dtype=np.int64)
    mb, nb = B.shape
    m, n = mb * lift, nb * lift
    H = np.zeros((m, n), dtype=np.uint8)
    eye = np.eye(lift, dtype=np.uint8)
    for i in range(mb):
        for j in range(nb):
            s = B[i, j]
            if s >= 0:
                H[i * lift : (i + 1) * lift, j * lift : (j + 1) * lift] = np.roll(
                    eye, int(s) % lift, axis=1
                )
    return LDPCCode(n=n, k=n - m, H=H, max_iterations=max_iterations)


def create_dvbs2_like_code(
    n: int = 16200,
    k: int = 7200,
    seed: int = 0,
    max_iterations: int = 50,
) -> LDPCCode:
    """A genuinely low-density irregular repeat-accumulate-style code with
    DVB-S2-short-frame dimensions (16200, 7200).

    Honest replacement for the reference's ``create_dvbs2_code``
    (``training_framework.py:379-400``), which returns a ~50%-dense random
    matrix mislabeled as DVB-S2 (SURVEY §8.7). Structure: information columns
    get degree-3 PEG-style placement; parity columns form the standard IRA
    dual-diagonal (degree-2 staircase), as in the actual DVB-S2 family.
    """
    m = n - k
    rng = np.random.default_rng(seed)
    rows = []
    cols = []
    # information part: degree 3, balanced across checks
    dv = 3
    base = np.repeat(np.arange(m), int(np.ceil(k * dv / m)) + 1)
    perm = base[rng.permutation(base.shape[0])]
    ptr = 0
    for j in range(k):
        seen = set()
        while len(seen) < dv:
            r = int(perm[ptr % perm.shape[0]])
            ptr += 1
            if r not in seen:
                seen.add(r)
        for r in seen:
            rows.append(r)
            cols.append(j)
    # parity part: dual-diagonal staircase
    for p in range(m):
        rows.append(p)
        cols.append(k + p)
        if p > 0:
            rows.append(p)
            cols.append(k + p - 1)
    H = np.zeros((m, n), dtype=np.uint8)
    H[rows, cols] = 1
    return LDPCCode(n=n, k=k, H=H, max_iterations=max_iterations)


def create_pbrl_like_code(
    k: int = 1032,
    rate: float = 1 / 3,
    seed: int = 0,
    max_iterations: int = 50,
) -> LDPCCode:
    """Protograph-based raptor-like (PBRL) style code with the paper's k=1032.

    The paper's lowest-rate PBRL instance is (3096, 1032) (paper §VII-C);
    higher rates are obtained by dropping parity columns. We build a
    highest-rate core (IRA-like) plus incremental-redundancy degree-1 rows,
    which is the defining PBRL structure.
    """
    n = int(round(k / rate))
    m = n - k
    rng = np.random.default_rng(seed)
    # core: IRA structure over the first m_core checks
    m_core = min(m, k)
    code = create_dvbs2_like_code(n=k + m_core, k=k, seed=seed,
                                  max_iterations=max_iterations)
    H_core = code.H
    if m == m_core:
        return LDPCCode(n=n, k=k, H=H_core, max_iterations=max_iterations)
    # incremental redundancy: each extra check connects a few info bits and
    # one fresh degree-1 parity bit (raptor-like rows)
    m_ir = m - m_core
    H = np.zeros((m, n), dtype=np.uint8)
    H[:m_core, : k + m_core] = H_core
    for t in range(m_ir):
        i = m_core + t
        picks = rng.choice(k, size=3, replace=False)
        H[i, picks] = 1
        H[i, k + m_core + t] = 1  # fresh degree-1 parity variable
    return LDPCCode(n=n, k=k, H=H, max_iterations=max_iterations)


# ---------------------------------------------------------------------------
# alist IO (standard sparse LDPC interchange format)
# ---------------------------------------------------------------------------


def load_alist(path: str, max_iterations: int = 50) -> LDPCCode:
    """Load a parity-check matrix in MacKay's alist format."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    n = int(next(it))
    m = int(next(it))
    max_cw = int(next(it))
    next(it)  # max row weight
    [int(next(it)) for _ in range(n)]  # column weights
    [int(next(it)) for _ in range(m)]  # row weights
    H = np.zeros((m, n), dtype=np.uint8)
    for j in range(n):
        for _ in range(max_cw):  # lines are zero-padded to max_cw
            r = int(next(it))
            if r > 0:  # alist is 1-based; 0 entries are padding
                H[r - 1, j] = 1
    return LDPCCode(n=n, k=n - m, H=H, max_iterations=max_iterations)


def save_alist(code: LDPCCode, path: str) -> None:
    """Write a parity-check matrix in MacKay's alist format."""
    H = code.H
    m, n = H.shape
    col_lists = [list(np.flatnonzero(H[:, j]) + 1) for j in range(n)]
    row_lists = [list(np.flatnonzero(H[i, :]) + 1) for i in range(m)]
    max_cw = max(len(c) for c in col_lists)
    max_rw = max(len(r) for r in row_lists)
    lines = [f"{n} {m}", f"{max_cw} {max_rw}"]
    lines.append(" ".join(str(len(c)) for c in col_lists))
    lines.append(" ".join(str(len(r)) for r in row_lists))
    for c in col_lists:
        lines.append(" ".join(str(x) for x in c + [0] * (max_cw - len(c))))
    for r in row_lists:
        lines.append(" ".join(str(x) for x in r + [0] * (max_rw - len(r))))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def save_protograph(base_matrix: np.ndarray, lift: int, path: str) -> None:
    """Write a QC protograph (shift matrix + lift) as text.

    alist flattens the lifted H and loses the circulant structure the QC
    fast path needs; this format round-trips it. Line 1: ``mb nb lift``;
    then mb rows of nb shift entries (-1 = zero block).
    """
    B = np.asarray(base_matrix, dtype=np.int64)
    mb, nb = B.shape
    lines = [f"{mb} {nb} {lift}"]
    for i in range(mb):
        lines.append(" ".join(str(int(x)) for x in B[i]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_protograph(path: str):
    """Load a protograph saved by :func:`save_protograph`.

    Returns ``(base_matrix [mb, nb], lift)`` — feed to
    :func:`create_qc_code` and ``decode.qc_engine.build_qc_graph``.
    """
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    mb, nb, lift = int(next(it)), int(next(it)), int(next(it))
    B = np.array([[int(next(it)) for _ in range(nb)] for _ in range(mb)],
                 dtype=np.int64)
    return B, lift


def create_pbrl_family(
    k: int = 1032,
    rates: Tuple[float, ...] = (8 / 9, 2 / 3, 1 / 2, 1 / 3),
    seed: int = 0,
    max_iterations: int = 50,
) -> Dict[float, LDPCCode]:
    """Rate-compatible PBRL family sharing one mother structure.

    The paper trains *rate-specific* weights for a k=1032 PBRL family at
    rates 1/3..8/9 (paper §VII-C: 4-bit rate-specific W-NMS-RCQ beats 6-bit
    OMS by 0.1-0.15 dB). PBRL rate compatibility = puncturing in reverse:
    the lowest-rate code's H contains every higher-rate code as the leading
    submatrix (drop incremental-redundancy rows AND their dedicated
    degree-1 parity columns to raise the rate).

    Returns {rate: LDPCCode}; every code's H is a leading submatrix of the
    lowest-rate mother code's H (verified in tests).
    """
    rates = tuple(sorted(rates))  # ascending; first = lowest rate = mother
    mother = create_pbrl_like_code(k=k, rate=rates[0], seed=seed,
                                   max_iterations=max_iterations)
    n_mother = mother.n
    m_mother = n_mother - k
    family: Dict[float, LDPCCode] = {rates[0]: mother}
    # core size: the IRA part built by create_pbrl_like_code
    m_core = min(m_mother, k)
    for r in rates[1:]:
        n_r = int(round(k / r))
        m_r = n_r - k
        if m_r >= m_mother:
            family[r] = mother
            continue
        if m_r < m_core:
            # higher rate than the core supports: rebuild a smaller core
            family[r] = create_pbrl_like_code(k=k, rate=r, seed=seed,
                                              max_iterations=max_iterations)
            continue
        H = mother.H[:m_r, :n_r]
        family[r] = LDPCCode(n=n_r, k=k, H=H,
                             max_iterations=max_iterations)
    return family


def create_dvbs2_qc_protograph(
    n: int = 16200,
    k: int = 7200,
    lift: int = 360,
    dv_info: int = 3,
    dv_info_high: int = 8,
    high_cols: Optional[int] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, int]:
    """IRA protograph with DVB-S2 structure and lift (the real standard is
    quasi-cyclic with lift 360), decodable on the QC fast path.

    Degree profile matches the genuine ETSI rate-1/2 structure: a
    leading group of info columns at high degree and the majority at
    degree 3, with parity columns forming the IRA dual-diagonal
    staircase (degree 2). The real rate-1/2 profile puts 40% of info
    bits at degree 8 (normal frame: 12960 of 32400 bits; degree 12-13
    appears only at rates >= 2/3), and every group of 360 info bits
    shares one degree — exactly one base column here. So ``high_cols``
    base columns (default ``2 * kb // 5``, i.e. 8 of 20 for the
    short-frame rate-1/2 dimensions) get ``dv_info_high`` (default 8)
    circulant blocks, the rest ``dv_info``. The uniform-dv profile of
    rounds 1-4 is recovered with ``high_cols=0``
    (``experiments/dvbs2_profile_de.py`` records the DE threshold of
    each profile variant). Returns ``(base_matrix, lift)`` for
    :func:`create_qc_code` / ``decode.qc_engine.build_qc_graph``.

    Honest replacement for the reference's ``create_dvbs2_code``
    (``training_framework.py:379-400``), which returns a ~50%-dense
    random matrix mislabeled as DVB-S2 (SURVEY §8.7).
    """
    if n % lift or k % lift:
        raise ValueError(f"n={n} and k={k} must be multiples of lift={lift}")
    nb, kb = n // lift, k // lift
    mb = nb - kb
    if dv_info > mb:
        raise ValueError(f"dv_info={dv_info} > base rows {mb}")
    if high_cols is None:
        high_cols = 2 * kb // 5
    dv_high = min(dv_info_high, mb)
    rng = np.random.default_rng(seed)
    B = np.full((mb, nb), -1, dtype=np.int64)
    # info columns: dv blocks on distinct rows, balanced across rows
    row_load = np.zeros(mb, dtype=np.int64)
    for j in range(kb):
        dv = dv_high if j < high_cols else dv_info
        rows = np.argsort(row_load
                          + rng.uniform(0, 0.5, mb))[:dv]
        for r in rows:
            B[r, j] = rng.integers(0, lift)
            row_load[r] += 1
    # parity columns: dual-diagonal staircase of shift-0 identities
    for p in range(mb):
        B[p, kb + p] = 0
        if p > 0:
            B[p, kb + p - 1] = 0
    return B, lift


# -- published-construction QC codes ----------------------------------------
# Real codes from the coding literature, generated from their published
# closed-form constructions (this environment has no network access to fetch
# standards' shift tables, so we ship codes whose exact H is *derivable*).
# Both are quasi-cyclic and decode through the QC roll engine.


def gf2_rank(H: np.ndarray) -> int:
    """Rank of a {0,1} matrix over GF(2) (row reduction on bigint rows)."""
    H = np.asarray(H, dtype=np.uint8)
    rows = []
    for r in H:
        x = 0
        for j in np.flatnonzero(r):
            x |= 1 << int(j)
        rows.append(x)
    rank = 0
    for j in range(H.shape[1]):
        msk = 1 << j
        piv = next((i for i in range(rank, len(rows)) if rows[i] & msk), None)
        if piv is None:
            continue
        rows[rank], rows[piv] = rows[piv], rows[rank]
        for i in range(len(rows)):
            if i != rank and rows[i] & msk:
                rows[i] ^= rows[rank]
        rank += 1
        if rank == len(rows):
            break
    return rank


def tanner_155_base() -> np.ndarray:
    """Base matrix of the Tanner (155, 64, 20) QC-LDPC code.

    Published construction (Tanner, Sridhara & Fuja 2001): a 3x5 array of
    31x31 circulants with shift ``5^i * 2^j mod 31`` (5 has multiplicative
    order 3 and 2 has order 5 mod 31). The resulting (3,5)-regular code has
    n=155, GF(2) rank 91 => k=64, girth 8, minimum distance 20 — the
    classic benchmark QC code of the LDPC literature.
    """
    return np.array([[(pow(5, i, 31) * pow(2, j, 31)) % 31
                      for j in range(5)] for i in range(3)])


def create_tanner_155(max_iterations: int = 50) -> LDPCCode:
    """The Tanner (155, 64, 20) code (see :func:`tanner_155_base`).

    ``k`` reflects the true GF(2) dimension (H's 93 rows have rank 91),
    verified at construction time.
    """
    code = create_qc_code(tanner_155_base(), lift=31,
                          max_iterations=max_iterations)
    k = code.n - gf2_rank(code.H)
    assert k == 64, f"Tanner construction broken: k={k}"
    return LDPCCode(n=code.n, k=k, H=code.H, max_iterations=max_iterations)


def create_array_code(p: int, j_rows: int = 3, k_cols: int = 5,
                      max_iterations: int = 50) -> LDPCCode:
    """Array LDPC code (Fan 2000): ``j_rows x k_cols`` array of ``p x p``
    circulants with shift ``i*l mod p`` (p prime, i row index, l column
    index). (j,k)-regular, girth >= 6; a standard deterministic QC family
    used throughout the literature (and the structural template of many
    standardized codes). ``k`` is the true GF(2) dimension.
    """
    if j_rows >= k_cols:
        raise ValueError("need j_rows < k_cols for a nontrivial code rate")
    base = np.array([[(i * l) % p for l in range(k_cols)]
                     for i in range(j_rows)])
    code = create_qc_code(base, lift=p, max_iterations=max_iterations)
    k = code.n - gf2_rank(code.H)
    return LDPCCode(n=code.n, k=k, H=code.H, max_iterations=max_iterations)


def create_pbrl_qc_protograph(
    k: int = 1032,
    rate: float = 1 / 3,
    lift: int = 86,
    dv_info: int = 3,
    ir_taps: int = 3,
    seed: int = 0,
    precode: bool = False,
    core_rate: Optional[float] = None,
):
    """QC-lifted PBRL protograph (paper §VII-C family, k=1032).

    Real PBRL codes are protograph codes lifted by circulants — which is
    what makes them implementable — so they belong on the QC roll
    engine / fused whole-decode kernel, not the gather path.
    :func:`create_pbrl_like_code` builds the same structure flat (for
    exercising the general/bucketed engines); this builder emits the
    ``(base_matrix, lift)`` form: an IRA core (info base columns with
    ``dv_info`` circulant blocks on distinct core rows + dual-diagonal
    staircase parity) and raptor-like incremental-redundancy rows (each
    taps ``ir_taps`` info columns and one fresh degree-1 parity column).

    Rate compatibility is by construction: for a higher rate ``r`` with
    ``mb_r = nb_r - kb`` base rows (``mb_r >= mb_core``), the leading
    submatrix ``B[:mb_r, :nb_r]`` is that rate's protograph — the same
    leading-submatrix property :func:`create_pbrl_family` verifies in the
    lifted domain.

    ``precode=True`` adds the defining feature of REAL PBRL designs
    (Divsalar-family protographs): one PUNCTURED high-degree precode
    column, tapped by every core row and every incremental-redundancy
    row. The punctured node is never transmitted (rate is over the
    remaining columns, so the base gains one column) but is resolved
    early with high reliability and feeds every IR check — which is
    what lets real PBRL codes carry degree-1 IR bits without the low-b
    absorbing-set floor our random variant measures (RESULTS §16/§19).
    Returns ``(base, lift, punctured_base_cols)`` — pass
    ``punctured_base_cols`` (base-column indices) expanded to bit
    positions to the simulator's ``punctured_positions`` and to
    ``design.protograph_density_evolution(punctured_cols=...)``.

    ``core_rate`` (precode only) sizes the IRA core for the family's
    HIGHEST rate instead of this code's rate: with a fixed core, the
    protograph at any rate ``r`` in ``[rate, core_rate]`` is EXACTLY the
    leading submatrix of this base — true raptor-like rate
    compatibility (paper §VII-C trains rate-specific weights on one
    such k=1032 family at rates 1/3..8/9). Build the family by calling
    this once per rate with the same ``(k, lift, seed, core_rate)``;
    nesting is verified in ``tests/test_codes.py``.
    """
    if k % lift:
        raise ValueError(f"k={k} must be a multiple of lift={lift}")
    n = int(round(k / rate))
    if n % lift:
        raise ValueError(f"n={n} (k/rate) must be a multiple of lift={lift}")
    core_rows = None
    if core_rate is not None:
        # real-PBRL family structure: the core is sized for the HIGHEST
        # rate of the family, and every lower rate is core + IR rows.
        # With a fixed core, B(r_hi) is EXACTLY the leading submatrix of
        # B(r_lo) for every core_rate >= r_hi >= r_lo (the prefix-stable
        # rng makes the draws identical) — true PBRL rate compatibility,
        # not just same-structure codes. Precode-only: the unprecoded
        # builder's core has no closing column, so shrinking it changes
        # the staircase shape.
        if not precode:
            raise ValueError("core_rate requires precode=True")
        n_core = int(round(k / core_rate))
        if n_core % lift:
            raise ValueError(f"core n={n_core} (k/core_rate) must be a "
                             f"multiple of lift={lift}")
        core_rows = n_core // lift - k // lift
    if precode:
        return _pbrl_qc_precoded(k // lift, n // lift, lift, dv_info,
                                 ir_taps, seed, core_rows=core_rows)
    kb, nb = k // lift, n // lift
    mb = nb - kb
    mb_core = min(mb, kb)
    if dv_info > mb_core:
        raise ValueError(f"dv_info={dv_info} > core rows {mb_core}")
    rng = np.random.default_rng(seed)
    B = np.full((mb, nb), -1, dtype=np.int64)
    # IRA core: info columns spread over core rows, staircase parity
    row_load = np.zeros(mb_core, dtype=np.int64)
    for j in range(kb):
        rows = np.argsort(row_load + rng.uniform(0, 0.5, mb_core))[:dv_info]
        for r in rows:
            B[r, j] = rng.integers(0, lift)
            row_load[r] += 1
    for p in range(mb_core):
        B[p, kb + p] = 0
        if p > 0:
            B[p, kb + p - 1] = 0
    # incremental-redundancy rows: ir_taps info blocks + a fresh degree-1
    # parity block each (the defining raptor-like extension)
    for t in range(mb - mb_core):
        i = mb_core + t
        for j in rng.choice(kb, size=ir_taps, replace=False):
            B[i, j] = rng.integers(0, lift)
        B[i, kb + mb_core + t] = 0
    return B, lift


def _pbrl_qc_precoded(kb: int, nb_tx: int, lift: int, dv_info: int,
                      ir_taps: int, seed: int,
                      core_rows: Optional[int] = None):
    """Precoded PBRL base (see :func:`create_pbrl_qc_protograph`).

    Column layout: [precode (punctured) | kb info | mb_core-1 staircase
    parity | n_ir degree-1 IR parity]; the precode column taps EVERY
    row, closing the core structure in place of the missing staircase
    column (nb - mb = kb, so the lifted code still carries kb*lift info
    bits while transmitting nb_tx*lift symbols — same transmitted rate
    as the unprecoded builder)."""
    mb = nb_tx - kb + 1
    mb_core = min(mb - 1, kb if core_rows is None else core_rows)
    n_ir = mb - mb_core
    nb = nb_tx + 1
    if mb_core < 2 or dv_info > mb_core:
        raise ValueError(f"rate too high for a precoded core: mb_core="
                         f"{mb_core}, dv_info={dv_info}")
    if core_rows is not None and mb - 1 < core_rows:
        raise ValueError(f"rate above core_rate: mb-1={mb - 1} < "
                         f"core_rows={core_rows}")
    rng = np.random.default_rng(seed)
    B = np.full((mb, nb), -1, dtype=np.int64)
    # rng consumption is prefix-stable in the rate: core draws first, then
    # one draw group per IR row — so a higher rate's protograph is exactly
    # the leading submatrix of a lower rate's (same rate-compatibility
    # property as the unprecoded builder; verified in tests)
    B[:mb_core, 0] = rng.integers(0, lift, size=mb_core)  # precode, core
    row_load = np.zeros(mb_core, dtype=np.int64)
    for j in range(1, kb + 1):
        rows = np.argsort(row_load + rng.uniform(0, 0.5, mb_core))[:dv_info]
        for r in rows:
            B[r, j] = rng.integers(0, lift)
            row_load[r] += 1
    for p in range(mb_core - 1):               # dual-diagonal staircase
        B[p, kb + 1 + p] = 0
        B[p + 1, kb + 1 + p] = 0
    for t in range(n_ir):
        i = mb_core + t
        B[i, 0] = rng.integers(0, lift)        # precode taps this IR row
        for j in rng.choice(kb, size=ir_taps, replace=False) + 1:
            B[i, j] = rng.integers(0, lift)
        B[i, kb + mb_core + t] = 0
    return B, lift, (0,)

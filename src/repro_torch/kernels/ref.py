"""Plain PyTorch versions of the port's kernels.

Twins of ``repro.kernels.ref``: the CPU path runs them, the tests hold them
against the JAX package, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Nothing on the CUDA join path calls them.  The
join kernels' outputs are integers or bools, so those comparisons are
exact; :func:`flash_attention_ref` is floating point and is compared with a
tolerance.

The verdict's float32 prune test is replaced by the integer
:func:`repro_torch.core.bounds.prune_table` (``table``); when a caller
passes none, one is built that covers the lengths given.
"""

from __future__ import annotations

import torch

from repro_torch.core import bounds, verify
from repro_torch.core.bitmap import (GENERATORS, hamming_packed, pack_bits, popcount32,
                                     popcount_rows, unpack_planes)
from repro_torch.core.bounds import positional_upper_bound_int


def bitmap_build_ref(tokens: torch.Tensor, lengths: torch.Tensor, b: int, method: str,
                     mix: bool = False) -> torch.Tensor:
    """Packed int32[N, b // 32] words of ``method`` ('set', 'xor' or
    'next'): the bit-matrix generators of :mod:`repro_torch.core.bitmap`,
    then :func:`~repro_torch.core.bitmap.pack_bits`."""
    if method not in GENERATORS:
        raise ValueError(f"unknown bitmap method {method!r}; one of {sorted(GENERATORS)}")
    return pack_bits(GENERATORS[method](tokens, lengths, b, mix))


# All-pairs Hamming distance, int32[NR, W] x int32[NS, W] -> int32[NR, NS]
# (one word at a time, so the (NR, NS, W) cross product is never built).
hamming_matrix_ref = hamming_packed


def bitplane_hamming_ref(planes_r: torch.Tensor, planes_s: torch.Tensor,
                         pc_r: torch.Tensor, pc_s: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance from {0, 1} int8 bit planes: int8[NR, b] x
    int8[NS, b] plus int32 row popcounts -> int32[NR, NS] =
    ``pc_r[:, None] + pc_s[None, :] - 2 * planes_r @ planes_s.T``.

    The inner products go through a float64 matrix product, which is exact
    here (every partial sum is an integer of at most b < 2^53) and runs on
    the CPU and the card alike (CUDA has no integer matmul)."""
    dot = (planes_r.to(torch.float64) @ planes_s.to(torch.float64).T).to(torch.int32)
    return pc_r.to(torch.int32)[:, None] + pc_s.to(torch.int32)[None, :] - 2 * dot


def bitplane_pair_hamming_ref(planes_r: torch.Tensor, planes_s: torch.Tensor,
                              pc_r: torch.Tensor, pc_s: torch.Tensor) -> torch.Tensor:
    """Pairwise bit-plane Hamming: int8[G, b] x 2 -> int32[G], the identity
    ``popcount(x ^ y) = pc(x) + pc(y) - 2 <bits(x), bits(y)>`` per candidate,
    in int32."""
    dot = (planes_r.to(torch.int32) * planes_s.to(torch.int32)).sum(-1, dtype=torch.int32)
    return pc_r.to(torch.int32) + pc_s.to(torch.int32) - 2 * dot


def prune_table_for(sim: str, tau: float, len_r: torch.Tensor,
                    len_s: torch.Tensor) -> torch.Tensor:
    """The device prune table covering every length in ``len_r``/``len_s``."""
    lmax_r = int(len_r.max()) if len_r.numel() else 0
    lmax_s = int(len_s.max()) if len_s.numel() else 0
    return verify.prune_table_dev(sim, tau, max(lmax_r, 0), max(lmax_s, 0),
                                  len_r.device)


def candidate_matrix_ref(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    len_r: torch.Tensor,
    len_s: torch.Tensor,
    *,
    sim: str,
    tau: float,
    self_join: bool,
    cutoff: int = 1 << 30,
    table: torch.Tensor | None = None,
    bitplane: bool = False,
) -> torch.Tensor:
    """Fused bitmap-filter verdicts -> bool[NR, NS] (self-join: global i<j).

    ``bitplane`` takes the Hamming distances from the {0, 1} bit planes and
    row popcounts (:func:`bitplane_hamming_ref`), the arithmetic of the
    tensor-core kernels, instead of the packed words; the result is the
    same."""
    if table is None:
        table = prune_table_for(sim, tau, len_r, len_s)
    if bitplane:
        ham = bitplane_hamming_ref(unpack_planes(words_r), unpack_planes(words_s),
                                   popcount_rows(words_r), popcount_rows(words_s))
    else:
        ham = hamming_matrix_ref(words_r, words_s)
    lr = len_r.to(torch.int32)[:, None]
    ls = len_s.to(torch.int32)[None, :]
    cand = bounds.verdict_from_hamming(ham, lr, ls, table, sim=sim, cutoff=cutoff)
    if self_join:
        cand &= _upper_triangle(words_r.shape[0], words_s.shape[0], words_r.device)
    return cand


def _upper_triangle(nr: int, ns: int, device) -> torch.Tensor:
    return (torch.arange(nr, device=device)[:, None]
            < torch.arange(ns, device=device)[None, :])


def count_candidates_ref(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    len_r: torch.Tensor,
    len_s: torch.Tensor,
    lo_s: torch.Tensor,
    hi_s: torch.Tensor,
    *,
    sim: str,
    tau: float,
    self_join: bool,
    cutoff: int = 1 << 30,
    window: bool = True,
    tile_r: int = 256,
    tile_s: int = 256,
    table: torch.Tensor | None = None,
    bitplane: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (window-pair count, candidate count) -> two int32[GR, GS].

    ``lo_s``/``hi_s`` are the integer admissible |s| windows per R row.  The
    last tiles count as if padded with empty (length-0) rows.  ``bitplane``
    as for :func:`candidate_matrix_ref`.
    """
    nr, ns = words_r.shape[0], words_s.shape[0]
    lr = len_r.to(torch.int32)[:, None]
    ls = len_s.to(torch.int32)[None, :]
    win = (lr > 0) & (ls > 0)
    if window:
        win &= (ls >= lo_s.to(torch.int32)[:, None]) & (ls <= hi_s.to(torch.int32)[:, None])
    if self_join:
        win &= _upper_triangle(nr, ns, words_r.device)
    cand = candidate_matrix_ref(words_r, words_s, len_r, len_s, sim=sim, tau=tau,
                                self_join=self_join, cutoff=cutoff, table=table,
                                bitplane=bitplane) & win

    def tile_sums(m):
        gr, gs = -(-nr // tile_r), -(-ns // tile_s)
        p = torch.zeros((gr * tile_r, gs * tile_s), dtype=torch.int32, device=m.device)
        p[:nr, :ns] = m.to(torch.int32)
        return p.reshape(gr, tile_r, gs, tile_s).sum(dim=(1, 3), dtype=torch.int32)

    return tile_sums(win), tile_sums(cand)


def entry_filter_ref(
    len_r: torch.Tensor,
    pos_r: torch.Tensor,
    len_s: torch.Tensor,
    pos_s: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    idx_r: torch.Tensor,
    idx_s: torch.Tensor,
    valid: torch.Tensor,
    *,
    sim: str,
    tau: float,
    self_join: bool,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Postings-entry admission mask -> bool[G]: valid, both sets non-empty,
    ``lo <= |r| <= hi``, the Section 2.3.3 positional bound at this prefix
    position reaching the prune table's threshold, and (self-join) the
    strict ``idx_r < idx_s`` triangle in sorted ids."""
    if table is None:
        table = prune_table_for(sim, tau, len_r, len_s)
    lr = len_r.to(torch.int32)
    ls = len_s.to(torch.int32)
    ub = positional_upper_bound_int(lr, ls, pos_r, pos_s)
    ok = (valid & (lr > 0) & (ls > 0)
          & (lr >= lo.to(torch.int32)) & (lr <= hi.to(torch.int32))
          & (ub >= bounds.min_overlap_gather(sim, table, lr, ls)))
    if self_join:
        ok &= idx_r < idx_s
    return ok


def pair_verdict_ref(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    len_r: torch.Tensor,
    len_s: torch.Tensor,
    *,
    sim: str,
    tau: float,
    cutoff: int = 1 << 30,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pairwise bitmap-filter verdict over gathered candidate rows ->
    bool[G]: ``candidate_matrix_ref``'s test on ``words_r[g]`` against
    ``words_s[g]`` (the diagonal of the dense verdict)."""
    if table is None:
        table = prune_table_for(sim, tau, len_r, len_s)
    ham = popcount32(words_r ^ words_s).sum(-1, dtype=torch.int32)
    return bounds.verdict_from_hamming(ham, len_r.to(torch.int32), len_s.to(torch.int32),
                                       table, sim=sim, cutoff=cutoff)


# Rows of the (cap, L) token gathers that verdict_verify_ref holds at once.
_VERIFY_ROWS = 1 << 22
_INT32_MAX = 2**31 - 1


def expand_filter_ref(
    rng_flat: torch.Tensor,
    cnt: torch.Tensor,
    seg_end: torch.Tensor,
    post_set: torch.Tensor,
    post_pos: torch.Tensor,
    post_len: torch.Tensor,
    probe_lengths: torch.Tensor,
    lo_r: torch.Tensor,
    hi_r: torch.Tensor,
    s0: int,
    *,
    sim: str,
    tau: float,
    cap: int,
    lp: int,
    self_join: bool,
    table: torch.Tensor | None = None,
    entry_filter=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A probe chunk's CSR expansion and entry admission -> ``(rr, ss)``,
    int32[cap] each, ``INT32_MAX`` in the slots not admitted: the indexed
    driver's stage 1 after the window lookups (the reference's
    ``expand_and_filter`` from its ``arange`` on).  ``rng_flat``, ``cnt`` and
    ``seg_end`` are int32[C * lp]: each (probe, prefix position)'s
    window-narrowed CSR start and count, and the counts' inclusive prefix
    sum.  ``entry_filter`` is the admission test, called as
    :func:`entry_filter_ref` is (the default); ``ops`` passes a CUDA
    kernel's entry there to run this composition on the card."""
    entry_filter = entry_filter_ref if entry_filter is None else entry_filter
    dev = rng_flat.device
    n_expanded = seg_end[-1]
    g = torch.arange(cap, dtype=torch.int32, device=dev)
    k = torch.searchsorted(seg_end, g, right=True).clamp_(0, rng_flat.shape[0] - 1)
    in_range = g < n_expanded
    within = g - (seg_end[k] - cnt[k])
    pidx = (rng_flat[k] + within).clamp_(0, post_set.shape[0] - 1)
    r_idx = post_set[pidx]
    s_loc = torch.div(k, lp, rounding_mode="floor").to(torch.int32)
    keep = entry_filter(
        post_len[pidx], post_pos[pidx],
        probe_lengths[s_loc], (k % lp).to(torch.int32),
        lo_r[s_loc], hi_r[s_loc],
        r_idx, s0 + s_loc, in_range,
        sim=sim, tau=tau, self_join=self_join, table=table)
    rr = torch.where(keep, r_idx, _INT32_MAX)
    ss = torch.where(keep, s_loc, _INT32_MAX)
    return rr, ss


def _overlap_gathered(tokens_r, safe_r, probe_tokens, safe_s) -> torch.Tensor:
    """int32[cap] exact overlaps of ``tokens_r[safe_r]`` and
    ``probe_tokens[safe_s]``, gathered ``_VERIFY_ROWS`` rows at a time so
    the (cap, L) token gathers never all sit in memory together."""
    cap = safe_r.shape[0]
    if cap <= _VERIFY_ROWS:
        return verify.pairwise_overlap(tokens_r[safe_r], probe_tokens[safe_s])
    out = torch.empty(cap, dtype=torch.int32, device=safe_r.device)
    for a in range(0, cap, _VERIFY_ROWS):
        b = min(a + _VERIFY_ROWS, cap)
        out[a:b] = verify.pairwise_overlap(tokens_r[safe_r[a:b]],
                                           probe_tokens[safe_s[a:b]])
    return out


def verdict_verify_ref(
    tokens_r: torch.Tensor,
    lengths_r: torch.Tensor,
    words_r: torch.Tensor,
    probe_tokens: torch.Tensor,
    probe_lengths: torch.Tensor,
    probe_words: torch.Tensor,
    cand_r: torch.Tensor,
    cand_s: torch.Tensor,
    slot_ok: torch.Tensor,
    need_tab: torch.Tensor,
    *,
    sim: str,
    tau: float,
    cutoff: int = 1 << 30,
    table: torch.Tensor | None = None,
    pair_verdict=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pairwise bitmap verdict and exact verification of a candidate
    buffer -> ``(cand_mask, ok)``, bool[cap] each: the indexed driver's
    stage 3 before its compaction (the reference's ``verdict_and_verify`` up
    to its counts).  ``cand_mask`` is ``slot_ok`` and the verdict of
    ``words_r[cand_r]`` against ``probe_words[cand_s]``; ``ok`` is
    ``cand_mask`` and the exact overlap of the two token rows reaching the
    min-overlap table ``need_tab`` (integer-exact, identical to the f64
    oracle; the prune table only ever prunes).  ``pair_verdict`` is the
    verdict, called as :func:`pair_verdict_ref` is (the default); ``ops``
    passes a CUDA kernel's entry, or the bit-plane plain verdict, there."""
    pair_verdict = pair_verdict_ref if pair_verdict is None else pair_verdict
    safe_r = torch.where(slot_ok, cand_r, 0)
    safe_s = torch.where(slot_ok, cand_s, 0)
    bm_pass = pair_verdict(
        words_r[safe_r], probe_words[safe_s],
        lengths_r[safe_r], probe_lengths[safe_s],
        sim=sim, tau=tau, cutoff=cutoff, table=table)
    cand_mask = slot_ok & bm_pass
    o = _overlap_gathered(tokens_r, safe_r, probe_tokens, safe_s)
    need = bounds.min_overlap_gather(sim, need_tab, lengths_r[safe_r],
                                     probe_lengths[safe_s])
    return cand_mask, cand_mask & (o >= need)


# ---------------------------------------------------------------------------
# Flash attention forward (the LM scaffold's prefill attention)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def flash_chunks(sq: int, sk: int, q_chunk: int = 512, kv_chunk: int = 512) -> tuple[int, int]:
    """The chunk rule of ``repro.models.layers.flash_attention``: at most
    ``q_chunk`` query rows (and at least 16 chunks once S >= 1024), at most
    ``kv_chunk`` keys, each halved until it divides its length."""
    q_chunk = min(q_chunk, sq, max(sq // 16, 64))
    kv_chunk = min(kv_chunk, sk)
    while sq % q_chunk:
        q_chunk //= 2
    while sk % kv_chunk:
        kv_chunk //= 2
    return q_chunk, kv_chunk


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to the
    nearest value with 10 mantissa bits, ties away from zero, the low 13 bits
    of the float32 pattern zero.  On the int32 bit pattern: add half of the
    dropped unit, clear the 13 bits (a carry out of the mantissa bumps the
    exponent, up to inf).  inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact
    in float32), so |x - (hi + lo)| <= 2^-22 |x| for normal x (and at most
    2^-137 below the normal range): the split of the 3xTF32 flash instance."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


# Slot i of each group of 8 keys of V^T holds key SLOT_KEYS[i]: the TF32
# A fragment takes a lane's S accumulators (keys 2t, 2t + 1) as slots t, t + 4.
SLOT_KEYS = (0, 2, 4, 6, 1, 3, 5, 7)


def split_kv_ref(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The plain version of ``split_kv_cuda``: float32 k, v (B, Sk, KV, D) ->
    (k_hi, k_lo) (B, Sk, KV, D) and (vt_hi, vt_lo) (B, KV, D, Skp), Skp = Sk
    rounded up to 8: V transposed, slot 8 j + i of a row holding key 8 j +
    ``SLOT_KEYS[i]``, zeros past Sk."""
    b, sk, kv, d = v.shape
    skp = -(-sk // 8) * 8
    vt = torch.zeros((b, kv, d, skp), dtype=torch.float32, device=v.device)
    vt[..., :sk] = v.permute(0, 2, 3, 1)
    order = (torch.arange(skp, device=v.device) // 8 * 8
             + torch.tensor(SLOT_KEYS, device=v.device).repeat(skp // 8))
    return (*split_tf32(k.float()), *split_tf32(vt[..., order]))


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, tf32x3: bool) -> torch.Tensor:
    """``einsum(eq, a, b)`` in float32, or as the 3xTF32 instance takes it:
    a_lo b_hi + a_hi b_lo + a_hi b_hi of the split parts, in float64 and
    rounded once to float32 (the dropped a_lo b_lo is 2^-22 relative)."""
    if not tf32x3:
        return torch.einsum(eq, a, b)
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    f = lambda x, y: torch.einsum(eq, x.double(), y.double())  # noqa: E731
    return (f(al, bh) + f(ah, bl) + f(ah, bh)).float()


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_chunk: int = 512, kv_chunk: int = 512,
                        triangle: bool = False, tf32x3: bool = False,
                        return_lse: bool = False, q_offset: int = 0):
    """GQA attention forward, blockwise with an online softmax: the plain
    version of ``flash_attention_cuda``.  With ``return_lse``, ``(out,
    lse)``: lse = m + log(max(l, 1e-30)) of each query row, float32 (B, KV,
    G, Sq), as ``_flash_fwd`` returns it.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H % KV == 0; query head h
    reads KV head h // (H / KV).  Scores are ``(q . k) * D^-0.5``, masked to
    -1e30 above the diagonal when ``causal``: query row i sits at position
    ``q_offset + i`` and key j at j (a slice of the q sequence; a
    non-causal call ignores the offset).  The twin of ``repro.models.layers._flash_fwd`` with the TPU
    kernel's cast points: q and k go to float32 before the product, p goes
    to v's type before PV, sums are float32, and the output takes q's type.
    In float32 this is the reference's jnp path; in bf16 it rounds where the
    kernel rounds.  ``triangle`` skips the blocks above the diagonal, which
    contribute exactly nothing.  ``tf32x3`` (float32) takes both products as
    the 3xTF32 instance does (``_product``): the model of its arithmetic,
    held against the exact float32 reference in the tests.
    """
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if h % kv or k.shape != v.shape:
        raise ValueError(f"GQA needs H % KV == 0 and k, v alike: q {list(q.shape)}, "
                         f"k {list(k.shape)}, v {list(v.shape)}")
    g = h // kv
    q_chunk, kv_chunk = flash_chunks(sq, sk, q_chunk, kv_chunk)
    scale = d ** -0.5
    qf = q.float().reshape(b, sq, kv, g, d)
    kf = k.float()
    out = torch.empty((b, sq, kv, g, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, kv, g, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, q_chunk):
        q_blk = qf[:, q0:q0 + q_chunk]
        q_pos = torch.arange(q0, q0 + q_chunk, device=q.device) + q_offset
        o = torch.zeros((b, kv, g, q_chunk, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, kv, g, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kv, g, q_chunk), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, kv_chunk):
            if triangle and causal and k0 > q_offset + q0 + q_chunk - 1:
                break
            s = _product("bqkgd,bckd->bkgqc", q_blk, kf[:, k0:k0 + kv_chunk], tf32x3) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kv_chunk, device=q.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            # p rounds to v's type; the product of two such values is exact
            # in float32, so a float32 product accumulates as the kernel does.
            pv = _product("bkgqc,bckd->bkgqd", p.to(v.dtype).float(),
                          v[:, k0:k0 + kv_chunk].float(), tf32x3)
            o = o * alpha[..., None] + pv
            m = m_new
        o = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        out[:, q0:q0 + q_chunk] = o.permute(0, 3, 1, 2, 4)
        lse[..., q0:q0 + q_chunk] = m + torch.log(torch.clamp(l, min=1e-30))
    out = out.reshape(b, sq, h, d)
    return (out, lse) if return_lse else out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, q_chunk: int = 512, kv_chunk: int = 512,
                            triangle: bool = False, q_offset: int = 0) -> tuple:
    """The attention backward, blockwise, p recomputed from lse: the twin of
    ``repro.models.layers._flash_bwd_impl``, with its chunk rule
    (:func:`flash_chunks`), its float32 accumulations and its casts (each
    block's products in the operands' type, then widened).  q, out, do (B,
    Sq, H, D); k, v (B, Sk, KV, D); lse (B, KV, G, Sq) from the forward.
    Returns (dq, dk, dv) in q's, k's and v's types.  ``q_offset``: the
    forward's (query row i at position ``q_offset + i``).

    When causal, a block wholly above the diagonal is skipped, triangle or
    not: its p is exactly 0, so the reference adds exact zeros there."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if h % kv or k.shape != v.shape or out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"GQA needs H % KV == 0, k, v alike and out, do like q: q "
                         f"{list(q.shape)}, k {list(k.shape)}, v {list(v.shape)}")
    g = h // kv
    q_chunk, kv_chunk = flash_chunks(sq, sk, q_chunk, kv_chunk)
    scale = d ** -0.5
    qg, dog = q.reshape(b, sq, kv, g, d), do.reshape(b, sq, kv, g, d)
    # D_i = rowsum(do * out), (B, KV, G, Sq).
    dsum = (do * out).float().sum(-1).reshape(b, sq, kv, g).permute(0, 2, 3, 1)
    dq = torch.empty((b, sq, kv, g, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, sk, kv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, sk, kv, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, q_chunk):
        q_blk, do_blk = qg[:, q0:q0 + q_chunk], dog[:, q0:q0 + q_chunk]
        lse_blk, d_blk = lse[..., q0:q0 + q_chunk, None], dsum[..., q0:q0 + q_chunk, None]
        q_pos = torch.arange(q0, q0 + q_chunk, device=q.device) + q_offset
        dq_i = torch.zeros((b, q_chunk, kv, g, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, kv_chunk):
            if causal and k0 > q_offset + q0 + q_chunk - 1:
                break
            k_blk, v_blk = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqkgd,bckd->bkgqc", q_blk, k_blk).float() * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kv_chunk, device=q.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            p = torch.exp(s - lse_blk)                                    # (B, KV, G, Cq, Ck)
            dv_c = torch.einsum("bkgqc,bqkgd->bckd", p.to(do.dtype), do_blk)
            dp = torch.einsum("bqkgd,bckd->bkgqc", do_blk, v_blk).float()
            ds = p * (dp - d_blk)
            dq_c = torch.einsum("bkgqc,bckd->bqkgd", ds.to(k.dtype), k_blk)
            dk_c = torch.einsum("bkgqc,bqkgd->bckd", ds.to(q.dtype), q_blk)
            dq_i = dq_i + dq_c.float() * scale
            dk[:, k0:k0 + kv_chunk] += (dk_c * scale).float()
            dv[:, k0:k0 + kv_chunk] += dv_c.float()
        dq[:, q0:q0 + q_chunk] = dq_i
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

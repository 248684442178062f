"""The span kernel and the row-level decode, in torch.

Port of smcpp_tpu/ops/hmm.py.  Observations are span-compressed rows
(span_l, key_l), packed into (C, L) batches padded with span-0 rows (the
identity).  Each row's transfer operator A_l = (diag(E[key_l]) T^T)^span_l
is formed by binary exponentiation with a rescale after every step
(``_row_operator``), batched over rows; rows are grouped into chunks of G
(a power of two) whose ordered products come from a pairwise tree
reduction (``_tree_reduce``).  Chunks from every contig are processed in
batches sized from a byte budget (``_batch_size``): memory is bounded by
one batch, whatever the genome's length.

What is serial is a scan over the chunk products, and that is the
per-contig boundary scan the window path already has
(window_kernel.contig_boundaries, K6 on a CUDA tensor), with the chunks as
its segments:

* ``estep``: the log-likelihood through ``SpanLoglik``, a
  torch.autograd.Function whose forward is K6 over the chunk products and
  whose backward takes the exact gradient from K6's normalised boundary
  vectors, then pushes it through each batch of chunk products recomputed
  with a tape (the reference's jax.checkpoint + lax.map).  The E-step
  statistics are the exponential-family identities gamma0 = pi dll/dpi,
  xisum = T dll/dT, gamma_sums = E dll/dE (hmm.cpp:97-153 of SMC++);
* ``decode_gammas``: K6's A_in and Q_end are the chunk-level forward and
  backward vectors; each chunk then decodes its rows at once
  (``_chunk_gammas``);
* ``viterbi_paths``: the row max-plus powers (``row_powers``), then the
  max-plus boundary scan (window_kernel.viterbi_boundary_states, K7 on a
  CUDA tensor) with the rows as its segments.  On the CPU it is the f64
  sequential loop of the reference (``viterbi_paths_plain``).

``_scan_chunks``, ``loglik``, ``posterior_gammas`` and
``viterbi_paths_plain`` are the plain sequential versions, kept as the
oracles.
"""

import numpy as np
import torch

from . import window_kernel as wk

# The reference's batch budget (256 MB), the default on every device; the
# manager passes its device budget on a GPU.
BATCH_BYTES = 1 << 28


def _rescale(mat, logs):
    "Normalize by the max-abs entry, tracking log scale.  (..., M, M)"
    m = torch.clamp(torch.amax(torch.abs(mat), dim=(-2, -1), keepdim=True),
                    min=torch.finfo(mat.dtype).tiny)
    return mat / m, logs + torch.log(m[..., 0, 0])


def _row_operator(B, span, nbits):
    """(diag(e) T^T)^span by binary exponentiation with rescaling, batched:
    B (R, M, M), span (R,) int.  Returns (A (R, M, M), log scale (R,))."""
    R, M = B.shape[0], B.shape[-1]
    A = torch.eye(M, dtype=B.dtype, device=B.device).expand(R, M, M)
    logA = torch.zeros(R, dtype=B.dtype, device=B.device)
    Bc, logBc = B, torch.zeros_like(logA)
    for i in range(nbits):
        bit = ((span >> i) & 1) == 1
        A, logA = _rescale(torch.where(bit[:, None, None], Bc @ A, A),
                           torch.where(bit, logA + logBc, logA))
        if i + 1 < nbits:  # the last square is never used
            Bc, logBc = _rescale(Bc @ Bc, 2.0 * logBc)
    return A, logA


def _tree_reduce(As, logs):
    """Ordered product As[..., G-1, :, :] @ ... @ As[..., 0, :, :] by pairwise
    tree reduction.  As: (..., G, M, M) with G a power of two, logs (...,
    G).  Returns ((..., M, M), (...))."""
    G, M = As.shape[-3], As.shape[-1]
    if G & (G - 1):
        raise ValueError(f"chunk size must be a power of two, got {G}")
    lead = As.shape[:-3]
    while G > 1:
        pair = As.reshape(*lead, G // 2, 2, M, M)
        lp = logs.reshape(*lead, G // 2, 2)
        As, logs = _rescale(pair[..., 1, :, :] @ pair[..., 0, :, :],
                            lp[..., 0] + lp[..., 1])
        G //= 2
    return As[..., 0, :, :], logs[..., 0]


def _row_products(B, spans, nbits):
    """Chunk products from row bases B (N, G, M, M) and spans (N, G):
    (N, M, M), (N,)."""
    N, G, M = B.shape[0], B.shape[1], B.shape[-1]
    As, logs = _row_operator(B.reshape(N * G, M, M), spans.reshape(-1), nbits)
    return _tree_reduce(As.view(N, G, M, M), logs.view(N, G))


def _chunk_product(T, E, spans, keys, nbits):
    """Transfer-operator products of a batch of chunks of compressed rows:
    spans, keys (N, G).  Returns (N, M, M), (N,)."""
    return _row_products(E[keys.long()][..., :, None] * T.T, spans, nbits)


def _batch_size(chunk, M, budget_bytes=BATCH_BYTES, itemsize=4):
    "How many chunks to process at once (peak ~6 buffers per element)."
    per = chunk * M * M * itemsize * 6
    return int(max(8, budget_bytes // per))


def _tape_batch_size(chunk, M, nbits, budget_bytes=BATCH_BYTES, itemsize=4):
    """Chunks a batch when the row operators are recorded for a backward: a
    row's tape holds about eight (M, M) tensors a bit of its exponent."""
    per = chunk * M * M * itemsize * (6 + 8 * nbits)
    return int(max(8, budget_bytes // per))


def _all_chunk_products(T, E, spans, keys, nbits, chunk, budget_bytes=None):
    """Chunk-operator products for a whole (C, L) batch of contigs, in
    batches of chunks.  Returns Ms (C, n_chunks, M, M) and logs (C,
    n_chunks)."""
    C, L = spans.shape
    M = T.shape[0]
    n_chunks = L // chunk
    sp = spans.reshape(C * n_chunks, chunk)
    ky = keys.reshape(C * n_chunks, chunk)
    bs = _batch_size(chunk, M, budget_bytes or BATCH_BYTES, T.element_size())
    Ms, logs = zip(*(_chunk_product(T, E, sp[i:i + bs], ky[i:i + bs], nbits)
                     for i in range(0, C * n_chunks, bs)))
    return (torch.cat(Ms).view(C, n_chunks, M, M),
            torch.cat(logs).view(C, n_chunks))


def _scan_chunks(pi, Ms, logs, cvalid=None):
    """Batched scaled-forward scan over chunk products, the plain sequential
    version.  Returns (C,) f64 loglik; ``cvalid`` (C,) bool zeroes padding
    contigs."""
    C, n_chunks, M, _ = Ms.shape
    alpha = pi.to(Ms.dtype).expand(C, M)
    ll = torch.zeros(C, dtype=torch.float64, device=Ms.device)
    for k in range(n_chunks):
        v = torch.einsum("cij,cj->ci", Ms[:, k], alpha)
        c = torch.sum(v, 1)
        dll = (torch.log(c) + logs[:, k]).to(torch.float64)
        if cvalid is not None:
            dll = torch.where(cvalid, dll, 0.0)
        ll = ll + dll
        alpha = v / c[:, None]
    return ll


def loglik(pi, T, E, spans, keys, nbits, chunk):
    """Total log-likelihood over a batch of contigs (spans/keys: (C, L)),
    differentiable by plain autograd through every chunk: the oracle."""
    Ms, logs = _all_chunk_products(T, E, spans, keys, nbits, chunk)
    cvalid = torch.any(spans > 0, 1)
    return torch.sum(_scan_chunks(pi, Ms, logs, cvalid))


def forward_loglik(pi, T, E, spans, keys, nbits, chunk):
    "Scaled-forward log-likelihood of one contig (spans/keys: (L,))."
    return loglik(pi, T, E, spans[None], keys[None], nbits, chunk)


def _chunk_layout(spans, chunk):
    """The chunks as K6's segments: the table (C, n_chunks) of chunk ids and
    seg_has (C n_chunks,), whether a chunk holds a row with span > 0."""
    C, L = spans.shape
    table = np.arange(C * (L // chunk)).reshape(C, L // chunk)
    return table, torch.any(spans.reshape(-1, chunk) > 0, 1)


def _boundaries(pi, T, E, spans, keys, nbits, chunk, budget_bytes):
    """The chunk products and K6 over them: (Ms (R, M, M), ll, A_in (R, M),
    Q_end (R, M), cvalid (C,)), R = C n_chunks."""
    M = T.shape[0]
    with torch.no_grad():
        Ms, logs = _all_chunk_products(T, E, spans, keys, nbits, chunk, budget_bytes)
    table, seg_has = _chunk_layout(spans, chunk)
    Ms, logs = Ms.view(-1, M, M), logs.view(-1)
    return (Ms, *wk.contig_boundaries(pi, Ms, logs, table, seg_has))


class SpanLoglik(torch.autograd.Function):
    """The log-likelihood of a (C, L) batch of contigs as a function of (pi,
    T, E): K6 over the chunk products forward; backward, the exact gradient
    from K6's boundary vectors.  A chunk's product M_c enters ll as
    log(q_c^T M_c a_c) (a_c = A_in, the forward vector entering it, q_c =
    Q_end, the backward vector leaving it, each up to a scale), so
    dll/dM_c = q_c a_c^T / (q_c^T M_c a_c), dll/dlogs_c = 1 (valid contigs
    only), and dll/dpi is a contig's first chunk's M^T q / (q^T M pi).  Each
    batch of chunk products is recomputed with a tape and given that
    upstream gradient; the per-row gradients reduce to T and E in f64."""

    @staticmethod
    def forward(ctx, pi, T, E, spans, keys, nbits, chunk, budget_bytes):
        Ms, ll, A_in, Q_end, cvalid = _boundaries(
            pi, T, E, spans, keys, nbits, chunk, budget_bytes)
        ctx.save_for_backward(pi, T, E, spans, keys)
        ctx.state = (Ms, A_in, Q_end, cvalid, nbits, chunk, budget_bytes)
        return ll

    @staticmethod
    def backward(ctx, gll):
        pi, T, E, spans, keys = ctx.saved_tensors
        Ms, A_in, Q_end, cvalid, nbits, chunk, budget_bytes = ctx.state
        del ctx.state
        f64, dt = torch.float64, T.dtype
        C, n_chunks = spans.shape[0], spans.shape[1] // chunk
        M = T.shape[0]
        a, q = A_in.to(f64), Q_end.to(f64)
        Mq = torch.einsum("rij,ri->rj", Ms.to(f64), q)  # M_c^T q_c
        w = cvalid.repeat_interleave(n_chunks).to(f64) * gll.to(f64)
        wd = w / torch.sum(Mq * a, 1)
        first = torch.arange(C, device=Ms.device) * n_chunks
        dpi = torch.sum(wd[first, None] * Mq[first], 0)
        sp = spans.reshape(-1, chunk)
        ky = keys.reshape(-1, chunk)
        dT = torch.zeros((M, M), dtype=f64, device=T.device)
        dE = torch.zeros(E.shape, dtype=f64, device=E.device)
        bs = _tape_batch_size(chunk, M, nbits, budget_bytes or BATCH_BYTES,
                              T.element_size())
        for i in range(0, sp.shape[0], bs):
            j = min(i + bs, sp.shape[0])
            e = E[ky[i:j].long()].detach()  # (N, G, M)
            B = (e[..., :, None] * T.detach().T).requires_grad_(True)
            with torch.enable_grad():
                Mb, lb = _row_products(B, sp[i:j], nbits)
                G = (q[i:j, :, None] * a[i:j, None, :]) * wd[i:j, None, None]
                (gB,) = torch.autograd.grad((Mb, lb), B, (G.to(dt), w[i:j].to(dt)))
            gB = gB.to(f64)  # B[n, g, i, j] = e[n, g, i] T[j, i]
            dT += torch.einsum("ngij,ngi->ji", gB, e.to(f64))
            dE.index_add_(0, ky[i:j].reshape(-1).long(),
                          torch.einsum("ngij,ji->ngi", gB, T.to(f64)).reshape(-1, M))
        return dpi.to(pi.dtype), dT.to(dt), dE.to(E.dtype), None, None, None, None, None


def estep(pi, T, E, spans, keys, nbits, chunk, budget_bytes=None):
    """E-step over a batch of contigs: log-likelihood + sufficient statistics.

    spans, keys: (C, L) padded with span == 0 rows.  Returns (ll f64, gamma0
    (M,), xisum (M, M), gamma_sums (n_keys, M)), the statistics summed over
    contigs in T's dtype (the reference's HMM::Q, hmm.cpp:155-193).  The
    serial scan is K6 on a CUDA tensor; ``budget_bytes`` sizes the batches
    of chunks (default ``BATCH_BYTES``)."""
    x = tuple(v.detach().requires_grad_(True) for v in (pi, T, E))
    ll = SpanLoglik.apply(*x, spans, keys, nbits, chunk, budget_bytes)
    gpi, gT, gE = torch.autograd.grad(ll, x)
    return ll.detach(), pi * gpi, T * gT, E * gE


def _chunk_gammas(T, E, spans, keys, a0, bG, nbits):
    """Per-row span-summed posterior masses for a batch of chunks of rows:
    spans, keys (N, G); a0 (N, M) the normalized forward vector entering
    each chunk, bG (N, M) the normalized backward vector leaving it.  Row
    l's gamma is the gradient of log(beta_l^T A_l(log e) alpha_{l-1}) with
    respect to a per-state log scale on its emission vector: binary
    exponentiation re-associates the span product, so the gradient through
    ``_row_operator`` is the posterior mass summed over the row's span, and
    each row's gamma sums to its span.  One backward of the sum of the rows'
    objectives gives every row's gradient (the rows are independent).
    Returns (N, G, M)."""
    N, G = spans.shape
    M = T.shape[0]
    tiny = torch.finfo(T.dtype).tiny
    e = E[keys.long()]
    with torch.enable_grad():
        ls = torch.zeros_like(e, requires_grad=True)
        B = (e * torch.exp(ls))[..., :, None] * T.T
        A, lg = _row_operator(B.reshape(N * G, M, M), spans.reshape(-1), nbits)
        A, lg = A.view(N, G, M, M), lg.view(N, G)
        Ad = A.detach()
        a, a_pre = a0, []
        for g in range(G):
            a_pre.append(a)
            v = torch.einsum("nij,nj->ni", Ad[:, g], a)
            a = v / torch.clamp(torch.sum(v, 1, keepdim=True), min=tiny)
        b, b_post = bG, [None] * G
        for g in range(G - 1, -1, -1):
            b_post[g] = b
            u = torch.einsum("nij,ni->nj", Ad[:, g], b)
            b = u / torch.clamp(torch.amax(u, 1, keepdim=True), min=tiny)
        obj = torch.log(torch.clamp(torch.einsum(
            "ngi,ngij,ngj->ng", torch.stack(b_post, 1), A, torch.stack(a_pre, 1)),
            min=tiny)) + lg
        (g,) = torch.autograd.grad(obj.sum(), ls)
    return g


def decode_gammas(pi, T, E, spans, keys, nbits, chunk, budget_bytes=None):
    """Row-resolution posterior decode for a padded (C, L) contig batch: the
    chunk products, K6 over them for each chunk's entering forward vector
    (A_in) and leaving backward vector (Q_end), then every chunk's rows at
    once (``_chunk_gammas``), in batches of chunks.  Returns (C, L, M);
    padding rows decode to zeros.  Equals ``posterior_gammas`` (the same
    mathematical definition)."""
    _, _, A_in, Q_end, _ = _boundaries(pi, T, E, spans, keys, nbits, chunk, budget_bytes)
    return rows_gammas(T, E, spans, keys, A_in, Q_end, nbits, chunk, budget_bytes)


def rows_gammas(T, E, spans, keys, A_in, Q_end, nbits, chunk, budget_bytes=None):
    """``decode_gammas`` from the chunks' boundary vectors A_in, Q_end (C
    n_chunks, M): ``_chunk_gammas`` in batches of chunks.  Returns (C, L,
    M), clamped at 0."""
    C, L = spans.shape
    M = T.shape[0]
    sp = spans.reshape(-1, chunk)
    ky = keys.reshape(-1, chunk)
    bs = _tape_batch_size(chunk, M, nbits, budget_bytes or BATCH_BYTES,
                          T.element_size())
    g = torch.cat([
        _chunk_gammas(T, E, sp[i:i + bs], ky[i:i + bs], A_in[i:i + bs],
                      Q_end[i:i + bs], nbits)
        for i in range(0, sp.shape[0], bs)])
    # posterior masses are nonnegative; f32 rounding can land ~-1e-8
    return torch.clamp(g.view(C, L, M), min=0.0)


def posterior_gammas(pi, T, E, spans, keys, nbits, chunk):
    """Per-row posterior state masses for one contig (spans/keys (L,)),
    summed over each row's span: the gradient of logL with respect to a
    per-row log scale on the emission vector, by plain autograd through
    every chunk and ``_scan_chunks``: the per-contig oracle of
    ``decode_gammas``."""
    L = spans.shape[0]
    M = pi.shape[0]
    n_chunks = L // chunk
    with torch.enable_grad():
        logd = torch.zeros((L, M), dtype=T.dtype, device=T.device, requires_grad=True)
        e = (E[keys.long()] * torch.exp(logd)).view(n_chunks, chunk, M)
        B = e[..., :, None] * T.T
        Ms, logs = _row_products(B, spans.view(n_chunks, chunk), nbits)
        ll = torch.sum(_scan_chunks(pi, Ms[None], logs[None]))
        (g,) = torch.autograd.grad(ll, logd)
    return g


# ---------------------------------------------------------------------------
# MAP (Viterbi) decoding: the max-plus analogue of the forward
# ---------------------------------------------------------------------------

def _mp_matmul(A, B):
    "Max-plus matrix product, batched: C[..., i, j] = max_k A[..., i, k] + B[..., k, j]."
    return torch.amax(A[..., :, :, None] + B[..., None, :, :], dim=-2)


def _mp_power(A, s, nbits):
    """Max-plus s-th power by binary exponentiation (s == 0 -> identity),
    batched: A (..., M, M), s an int tensor of shape A.shape[:-2]."""
    M = A.shape[-1]
    eye = torch.eye(M, dtype=torch.bool, device=A.device)
    result = torch.where(eye, 0.0, -torch.inf).to(A.dtype).expand(A.shape)
    base = A
    for b in range(nbits):
        take = ((s >> b) & 1) > 0
        result = torch.where(take[..., None, None], _mp_matmul(result, base), result)
        if b + 1 < nbits:  # the last square is never used
            base = _mp_matmul(base, base)
    return result


def _mp_batch_size(M, budget_bytes=BATCH_BYTES, itemsize=8):
    "Rows a batch of ``_mp_power``: its (B, M, M, M) broadcast, twice."
    return int(max(8, budget_bytes // (2 * M**3 * itemsize)))


def row_powers(T, E, spans, keys, nbits, budget_bytes=None):
    """Each row's max-plus operator W_l = (log T + log E[k_l])^{s_l} in T's
    dtype, W_l[i, j] the best log score from state i before the row to state
    j after it, in batches of rows.  spans, keys (C, L); returns (C L, M,
    M)."""
    M = T.shape[0]
    logT, logE = torch.log(T), torch.log(E)
    sp, ky = spans.reshape(-1), keys.reshape(-1).long()
    W = torch.empty((sp.shape[0], M, M), dtype=T.dtype, device=T.device)
    bs = _mp_batch_size(M, budget_bytes or BATCH_BYTES, T.element_size())
    for i in range(0, sp.shape[0], bs):
        j = min(i + bs, sp.shape[0])
        W[i:j] = _mp_power(logT + logE[ky[i:j]][:, None, :], sp[i:j], nbits)
    return W


def viterbi_paths_plain(pi, T, E, spans, keys, nbits, budget_bytes=None):
    """The reference's row-resolution MAP decode, batched over a padded (C,
    L) contig batch: the sequential max-plus loop over rows from log pi in
    T's dtype (f64 on the CPU: scores reach ~-1e5), the first maximizing
    previous state as backpointer, then the backtrace from the first
    argmax of the final scores.  Returns (C, L) int32, the MAP state at the
    end of each row; padding rows (span 0) repeat the adjacent state."""
    C, L = spans.shape
    M = T.shape[0]
    W = row_powers(T, E, spans, keys, nbits, budget_bytes).view(C, L, M, M)
    V = torch.log(pi.to(T.dtype)).expand(C, M)
    bps = torch.empty((C, L, M), dtype=torch.int64, device=T.device)
    for t in range(L):
        V, bps[:, t] = torch.max(V[:, :, None] + W[:, t], 1)
    bps = bps.cpu().numpy()
    state = torch.argmax(V, 1).cpu().numpy()
    path = np.empty((C, L), np.int32)
    rows = np.arange(C)
    for t in range(L - 1, -1, -1):
        path[:, t] = state
        state = bps[rows, t, state]
    return torch.as_tensor(path, device=T.device)


def _fill_padding(exit_, entry, real, pi):
    """Row states (C, L) from K7's per-row exit and entry states at real
    rows: a padding row takes the exit state of the last real row before
    it, or, before a contig's first real row, that row's entry state, or,
    in a contig with no real row, the first argmax of pi (the reference's
    backtrace through identity operators)."""
    C, L = real.shape
    idx = torch.arange(L, device=real.device).expand(C, L)
    last = torch.cummax(torch.where(real, idx, -1), 1).values
    has = torch.any(real, 1)
    first = torch.argmax(real.to(torch.int32), 1)
    lead = torch.where(has, entry.gather(1, first[:, None])[:, 0],
                       torch.argmax(pi).to(entry.device))
    return torch.where(last >= 0, exit_.gather(1, last.clamp(min=0)), lead[:, None])


def viterbi_paths(pi, T, E, spans, keys, nbits, budget_bytes=None):
    """Batched MAP decode over a padded (C, L) contig batch.  Returns (C,
    L) int32: the MAP state at the end of each row (within-row switches are
    collapsed into the row operator, the resolution of the posterior
    gammas).

    At M = 1 every state is 0.  On a CUDA tensor: the row powers in T's
    dtype (f64 from the manager), rounded to f32 and transposed to K7's
    (exit, entry) layout, then K7 with the rows as its segments (padding
    rows unlisted: the max-plus identity); the state at a row's end is its
    exit state.  Elsewhere ``viterbi_paths_plain``."""
    C, L = spans.shape
    M = T.shape[0]
    if M == 1:
        return torch.zeros((C, L), dtype=torch.int32, device=T.device)
    if not T.is_cuda:
        return viterbi_paths_plain(pi, T, E, spans, keys, nbits, budget_bytes)
    W = row_powers(T, E, spans, keys, nbits, budget_bytes)
    Wops = W.transpose(1, 2).to(torch.float32).contiguous()
    del W
    real = spans > 0
    sp = spans.cpu().numpy()
    table = np.where(sp > 0, np.arange(C * L).reshape(C, L), -1)
    entry, exit_ = wk.viterbi_boundary_states(pi, Wops, table)
    path = _fill_padding(exit_.view(C, L).long(), entry.view(C, L).long(), real, pi)
    return path.to(torch.int32)


def viterbi_path(pi, T, E, spans, keys, nbits):
    """MAP path of one contig (spans/keys (L,)): ``viterbi_paths`` of the
    one-contig batch.  Returns (L,) int32."""
    return viterbi_paths(pi, T, E, spans[None], keys[None], nbits)[0]

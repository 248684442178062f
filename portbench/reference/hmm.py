"""The coalescent HMM over span-compressed rows, worked out plainly: the
likelihood, the E-step's sufficient statistics, the posterior masses of
every row and the best path's score.

Each row (span s, key k) is the operator A = (diag(E[k]) T^T)^s, formed by
binary exponentiation with a rescale after each step; rows are grouped
into chunks of ``G`` and each chunk's ordered product comes from a pairwise
tree.  What is serial is a plain loop over the chunks of every contig at
once.  The statistics are the exponential-family identities gamma0 = pi
dll/dpi, xisum = T dll/dT, gamma_sums = E dll/dE, the gradient taken from
the chunks' boundary vectors and each batch of chunks recomputed under
autograd; a row's posterior mass is the gradient of the likelihood with
respect to a log scale on its emission vector.  These follow the port's
row-level oracles (smcpp_tpu_torch/ops/hmm.py), with the scans as plain
loops in the dtype of the inputs.  The Viterbi half is max-plus: the best
score over all paths, and the score of a given path of row-end states.
"""

import numpy as np
import torch

G = 128  # rows a chunk


def pack(rows_keys, chunk=G):
    """(spans, keys) lists of 1-D arrays -> (C, L) int64 arrays, each contig
    padded with span-0 rows (the identity) to one length, a multiple of
    ``chunk``."""
    n = max(len(s) for s, _ in rows_keys)
    L = -(-n // chunk) * chunk
    spans = np.zeros((len(rows_keys), L), np.int64)
    keys = np.zeros((len(rows_keys), L), np.int64)
    for i, (s, k) in enumerate(rows_keys):
        spans[i, : len(s)] = s
        keys[i, : len(k)] = k
    return spans, keys


def _rescale(mat, logs):
    m = torch.clamp(torch.amax(torch.abs(mat), dim=(-2, -1), keepdim=True),
                    min=torch.finfo(mat.dtype).tiny)
    return mat / m, logs + torch.log(m[..., 0, 0])


def _row_operator(B, span, nbits):
    "B^span by binary exponentiation, rescaled: B (R, M, M), span (R,)."
    R, M = B.shape[0], B.shape[-1]
    A = torch.eye(M, dtype=B.dtype, device=B.device).expand(R, M, M)
    logA = torch.zeros(R, dtype=B.dtype, device=B.device)
    Bc, logBc = B, torch.zeros_like(logA)
    for i in range(nbits):
        bit = ((span >> i) & 1) == 1
        A, logA = _rescale(torch.where(bit[:, None, None], Bc @ A, A),
                           torch.where(bit, logA + logBc, logA))
        if i + 1 < nbits:
            Bc, logBc = _rescale(Bc @ Bc, 2.0 * logBc)
    return A, logA


def _tree(As, logs):
    "Ordered product As[..., G-1] @ ... @ As[..., 0] by a pairwise tree."
    g, M = As.shape[-3], As.shape[-1]
    lead = As.shape[:-3]
    while g > 1:
        pair = As.reshape(*lead, g // 2, 2, M, M)
        lp = logs.reshape(*lead, g // 2, 2)
        As, logs = _rescale(pair[..., 1, :, :] @ pair[..., 0, :, :],
                            lp[..., 0] + lp[..., 1])
        g //= 2
    return As[..., 0, :, :], logs[..., 0]


def free_budget(device):
    "Bytes a batch of chunks may take: a quarter of the card's free memory."
    if torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0] * 0.25)
    return 1 << 28


def _bases(T, E, keys):
    "Each row's one-step operator diag(E[k]) T^T: keys (N, G) -> (N, G, M, M)."
    return E[keys][..., :, None] * T.T


def _chunk_products(B, spans, nbits):
    N, g, M = B.shape[0], B.shape[1], B.shape[-1]
    As, logs = _row_operator(B.reshape(N * g, M, M), spans.reshape(-1), nbits)
    return _tree(As.view(N, g, M, M), logs.view(N, g))


def _batch(M, nbits, budget, itemsize, tape):
    per = G * M * M * itemsize * (6 + (8 * nbits if tape else 0))
    return int(max(1, budget // per))


class Rows:
    """A batch of contigs as chunks of rows on ``device``: spans, keys (C,
    L) numpy arrays from ``pack``."""

    def __init__(self, spans, keys, device, budget=4 << 30):
        self.C, L = spans.shape
        self.n_chunks = L // G
        self.spans = torch.as_tensor(spans, device=device).view(-1, G)
        self.keys = torch.as_tensor(keys, device=device).view(-1, G)
        self.nbits = max(1, int(spans.max()).bit_length())
        self.real = torch.as_tensor(spans > 0, device=device)
        self.budget = budget

    def chunk_products(self, T, E):
        """Every chunk's product and log scale: (C n_chunks, M, M), (C
        n_chunks,)."""
        M = T.shape[0]
        bs = _batch(M, self.nbits, self.budget, T.element_size(), False)
        out = [_chunk_products(_bases(T, E, self.keys[i:i + bs]),
                               self.spans[i:i + bs], self.nbits)
               for i in range(0, self.spans.shape[0], bs)]
        return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])

    def boundaries(self, pi, Ms, logs):
        """The plain scan over the chunks: the log-likelihood (f64), each
        chunk's entering forward vector a (normalised to sum 1) and leaving
        backward vector q (normalised to max 1)."""
        C, nc, M = self.C, self.n_chunks, pi.shape[0]
        Ms = Ms.view(C, nc, M, M)
        logs = logs.view(C, nc)
        a = torch.empty((C, nc, M), dtype=Ms.dtype, device=Ms.device)
        q = torch.empty_like(a)
        alpha = pi.to(Ms.dtype).expand(C, M)
        ll = torch.zeros(C, dtype=torch.float64, device=Ms.device)
        for c in range(nc):
            a[:, c] = alpha
            v = torch.einsum("cij,cj->ci", Ms[:, c], alpha)
            s = v.sum(1)
            ll = ll + (torch.log(s) + logs[:, c]).to(torch.float64)
            alpha = v / s[:, None]
        beta = torch.ones((C, M), dtype=Ms.dtype, device=Ms.device)
        for c in range(nc - 1, -1, -1):
            q[:, c] = beta
            u = torch.einsum("cij,ci->cj", Ms[:, c], beta)
            beta = u / torch.amax(u, 1, keepdim=True)
        return ll.sum(), a.view(C * nc, M), q.view(C * nc, M)

    def estep(self, pi, T, E):
        """(ll, gamma0 (M,), xisum (M, M), gamma_sums (n_keys, M)), the
        statistics in float64."""
        f64 = torch.float64
        M = T.shape[0]
        with torch.no_grad():
            Ms, logs = self.chunk_products(T, E)
            ll, a, q = self.boundaries(pi, Ms, logs)
            Mq = torch.einsum("rij,ri->rj", Ms.to(f64), q.to(f64))
            wd = 1.0 / torch.sum(Mq * a.to(f64), 1)
            first = torch.arange(self.C, device=Ms.device) * self.n_chunks
            dpi = torch.sum(wd[first, None] * Mq[first], 0)
        del Ms, Mq
        dT = torch.zeros((M, M), dtype=f64, device=T.device)
        dE = torch.zeros(E.shape, dtype=f64, device=E.device)
        bs = _batch(M, self.nbits, self.budget, T.element_size(), True)
        Td = T.detach()
        for i in range(0, self.spans.shape[0], bs):
            j = min(i + bs, self.spans.shape[0])
            ky = self.keys[i:j]
            e = E[ky].detach()
            B = (e[..., :, None] * Td.T).requires_grad_(True)
            with torch.enable_grad():
                Mb, lb = _chunk_products(B, self.spans[i:j], self.nbits)
                up = (q[i:j, :, None] * a[i:j, None, :]) * wd[i:j, None, None].to(T.dtype)
                (gB,) = torch.autograd.grad(
                    (Mb, lb), B, (up, torch.ones_like(lb)))
            gB = gB.to(f64)
            dT += torch.einsum("ngij,ngi->ji", gB, e.to(f64))
            dE.index_add_(0, ky.reshape(-1),
                          torch.einsum("ngij,ji->ngi", gB, Td.to(f64)).reshape(-1, M))
        return (float(ll), (pi.to(f64) * dpi).cpu().numpy(),
                (Td.to(f64) * dT).cpu().numpy(), (E.to(f64) * dE).cpu().numpy())

    def gammas(self, pi, T, E):
        """Each row's posterior state masses summed over its span, (C, L, M)
        in T's dtype."""
        with torch.no_grad():
            Ms, logs = self.chunk_products(T, E)
            _, a, q = self.boundaries(pi, Ms, logs)
        del Ms
        M = T.shape[0]
        bs = _batch(M, self.nbits, self.budget, T.element_size(), True)
        out = [self._chunk_gammas(T, E, i, min(i + bs, self.spans.shape[0]), a, q)
               for i in range(0, self.spans.shape[0], bs)]
        return torch.cat(out).view(self.C, -1, M)

    def _chunk_gammas(self, T, E, i, j, a0, qG):
        sp, ky = self.spans[i:j], self.keys[i:j]
        N, M = sp.shape[0], T.shape[0]
        tiny = torch.finfo(T.dtype).tiny
        e = E[ky]
        with torch.enable_grad():
            ls = torch.zeros_like(e, requires_grad=True)
            B = (e * torch.exp(ls))[..., :, None] * T.T
            A, lg = _row_operator(B.reshape(N * G, M, M), sp.reshape(-1), self.nbits)
            A, lg = A.view(N, G, M, M), lg.view(N, G)
            Ad = A.detach()
            a, a_pre = a0[i:j], []
            for g in range(G):
                a_pre.append(a)
                v = torch.einsum("nij,nj->ni", Ad[:, g], a)
                a = v / torch.clamp(v.sum(1, keepdim=True), min=tiny)
            b, b_post = qG[i:j], [None] * G
            for g in range(G - 1, -1, -1):
                b_post[g] = b
                u = torch.einsum("nij,ni->nj", Ad[:, g], b)
                b = u / torch.clamp(torch.amax(u, 1, keepdim=True), min=tiny)
            obj = torch.log(torch.clamp(torch.einsum(
                "ngi,ngij,ngj->ng", torch.stack(b_post, 1), A,
                torch.stack(a_pre, 1)), min=tiny)) + lg
            (g,) = torch.autograd.grad(obj.sum(), ls)
        return g

    # -- max-plus ---------------------------------------------------------
    def viterbi_gap(self, pi, T, E, path):
        """The best path's log score over the reference's operators, and by
        how much the score of ``path`` ((C, L) states at each row's end,
        padding ignored) lies below it.  Returns (best, gap), f64."""
        C, nc, M = self.C, self.n_chunks, T.shape[0]
        logT, logE, logpi = torch.log(T), torch.log(E), torch.log(pi)
        path = torch.as_tensor(path, device=T.device).long()
        flat = path.reshape(-1)
        prev = torch.cat([flat[:1], flat[:-1]]).view(-1, G)
        path = path.view(-1, G)
        row0 = torch.zeros((C, nc * G), dtype=torch.bool, device=T.device)
        row0[:, 0] = True
        row0 = row0.view(-1, G)
        bs = max(1, int((self.budget // 4) // (G * 2 * M**3 * T.element_size())))
        P, score = [], torch.zeros((), dtype=torch.float64, device=T.device)
        for i in range(0, self.spans.shape[0], bs):
            j = min(i + bs, self.spans.shape[0])
            W = _mp_power(logT + logE[self.keys[i:j]][..., None, :],
                          self.spans[i:j], self.nbits)  # (N, G, M, M)
            N = j - i
            to = W.gather(3, path[i:j, :, None, None].expand(N, G, M, 1))[..., 0]
            inner = to.gather(2, prev[i:j, :, None])[..., 0]
            start = torch.amax(to + logpi, 2)
            real = self.spans[i:j] > 0
            term = torch.where(row0[i:j], start, inner)
            score = score + torch.where(real, term, 0.0).to(torch.float64).sum()
            P.append(_mp_tree(W))
        P = torch.cat(P).view(C, nc, M, M)
        V = logpi.expand(C, M)
        for c in range(nc):
            V = torch.amax(V[:, :, None] + P[:, c], 1)
        best = torch.amax(V, 1).to(torch.float64).sum()
        return float(best), float(best - score)


    def viterbi_path(self, pi, T, E):
        """A MAP path in T's dtype, (C, L) states at each row's end: the
        max-plus chunk products scanned for the vector entering each chunk,
        each chunk's rows walked forward from it with backpointers, and the
        backtrace from the last row's best state."""
        C, nc, M = self.C, self.n_chunks, T.shape[0]
        logT, logE, logpi = torch.log(T), torch.log(E), torch.log(pi)
        bs = max(1, int((self.budget // 4) // (G * 2 * M**3 * T.element_size())))
        n = self.spans.shape[0]

        def powers(i, j):
            return _mp_power(logT + logE[self.keys[i:j]][..., None, :],
                             self.spans[i:j], self.nbits)

        P = torch.cat([_mp_tree(powers(i, min(i + bs, n))) for i in range(0, n, bs)])
        P = P.view(C, nc, M, M)
        V_in = torch.empty((C, nc, M), dtype=T.dtype, device=T.device)
        V = logpi.expand(C, M)
        for c in range(nc):
            V_in[:, c] = V
            V = torch.amax(V[:, :, None] + P[:, c], 1)
        last = torch.argmax(V, 1).cpu().numpy()
        del P
        V_in = V_in.view(-1, M)
        bp = np.empty((n, G, M), np.int16)
        for i in range(0, n, bs):
            j = min(i + bs, n)
            W, v = powers(i, j), V_in[i:j]
            for g in range(G):
                v, b = torch.max(v[:, :, None] + W[:, g], 1)
                bp[i:j, g] = b.cpu().numpy()
        bp = bp.reshape(C, nc * G, M)
        path = np.empty((C, nc * G), np.int64)
        s, rows = last, np.arange(C)
        for r in range(nc * G - 1, -1, -1):
            path[:, r] = s
            s = bp[rows, r, s]
        return path


def _mp_matmul(A, B):
    return torch.amax(A[..., :, :, None] + B[..., None, :, :], dim=-2)


def _mp_power(A, s, nbits):
    "Max-plus s-th power (s == 0: the identity); A (..., M, M), s A.shape[:-2]."
    M = A.shape[-1]
    eye = torch.eye(M, dtype=torch.bool, device=A.device)
    result = torch.where(eye, 0.0, -torch.inf).to(A.dtype).expand(A.shape)
    base = A
    for b in range(nbits):
        take = ((s >> b) & 1) > 0
        if bool(take.any()):
            result = torch.where(take[..., None, None], _mp_matmul(result, base), result)
        if b + 1 < nbits:
            base = _mp_matmul(base, base)
    return result


def _mp_tree(W):
    "Ordered max-plus product W[..., 0] (x) ... (x) W[..., G-1]: (N, G, M, M)."
    while W.shape[1] > 1:
        W = _mp_matmul(W[:, 0::2], W[:, 1::2])
    return W[:, 0]

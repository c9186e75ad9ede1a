"""Plain torch versions of the port's kernels: the CPU path of ``ops`` and
the oracle the CUDA kernels are held to on the card.

``train_agg_step_ref`` takes its gradients from autograd over the loss
function, so it stays independent of the kernel's hand-derived backward.
``flash_attention_ref`` is dense O(S^2) attention, not the chunked scan of
``models.layers.flash_attention``: an independent formulation, so that the
two and the CUDA kernel cross-check; ``flash_attention_bwd_ref`` is its
gradient written out (dQ, dK, dV from q, k, v and dO), the plain version of
the backward kernel. ``wkv6_ref`` is the RWKV-6 recurrence
step by step, and ``models.rwkv6.wkv_chunked`` its matmul form;
``mamba_scan_ref`` the Mamba (S6) selective scan step by step.
``wkv6_bwd_ref`` and ``mamba_scan_bwd_ref`` are their gradients written
out as reverse-time loops (states recomputed a chunk at a time from
checkpoints, the algorithm of the backward kernels), with no autograd.
``swiglu_ref`` is ``models.layers.swiglu``, in its inputs' dtype.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers, mlp

__all__ = ["accum_flush_ref", "fed_agg_ref", "flash_attention_bwd_ref", "flash_attention_ref",
           "mamba_scan_bwd_ref", "mamba_scan_ref",
           "sum_in_order", "swiglu_ref", "train_agg_step_ref",
           "waterfill_energy_residual_ref", "waterfill_residual_ref", "wkv6_bwd_ref",
           "wkv6_ref"]


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """O(S^2) dense GQA attention with explicit masking
    (``repro.kernels.ref.flash_attention_ref``). q: (B, Sq, H, D); k, v:
    (B, Skv, KV, D) with H = KV * G; query and key positions both start at
    0. Scores, softmax and the PV product in float32, the result in q's
    dtype."""
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d).to(torch.float32)
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, k.to(torch.float32)) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask[None, :, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, dout, *, causal=True, window=None):
    """The gradient of ``flash_attention_ref``, written out densely in
    float32: returns (dq, dk, dv) in q's dtype. With the scaled scores s,
    P = exp(s - lse) over the allowed keys, D = rowsum(dO * out):
    dV = P^T dO and dK = dS^T q / sqrt(d), summed over each kv head's G
    query heads, dQ = dS k / sqrt(d), dS = P (dO v^T - D). A row with no
    key to attend to has lse -inf and gradients 0."""
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kv, g, d).to(torch.float32)
    dog = dout.reshape(b, sq, kv, g, d).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, kf) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    mask = mask[None, :, None, None, :]
    s = torch.where(mask, s, -math.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.where(mask & torch.isfinite(lse), torch.exp(s - lse), 0.0)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, vf)
    delta = (dog * out).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqkgd,bckd->bqkgc", dog, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bqkgc,bckd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bqkgc,bqkgd->bckd", ds, qg) * scale
    dv = torch.einsum("bqkgc,bqkgd->bckd", p, dog)
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def wkv6_ref(r, k, v, w, u, s0=None):
    """The RWKV-6 WKV recurrence, one step at a time
    (``repro.models.rwkv6.wkv_scan``). Per (batch, head), with the state
    S (hd, hd):

        y_t = r_t^T (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T.

    r, k, v, w: (B, S, H, hd); u: (H, hd); s0: (B, H, hd, hd) float32, or
    None for zeros. All arithmetic in float32. Returns (y float32
    (B, S, H, hd), s_last float32 (B, H, hd, hd))."""
    b, s, h, hd = r.shape
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)[..., :, None]
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
             if s0 is None else s0.to(torch.float32))
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        y[:, t] = torch.einsum("bhi,bhij->bhj", rf[:, t], state + uf * kv)
        state = wf[:, t, :, :, None] * state + kv
    return y, state


def mamba_scan_ref(dt, x, b, c, a, h0=None):
    """The Mamba (S6) selective scan, one step at a time
    (``repro.kernels.ref.mamba_scan_ref``). Per batch row and channel d,
    with the state h (D, N):

        h_t = exp(dt_t a) * h_{t-1} + (dt_t x_t) b_t,   y_t = h_t . c_t.

    dt, x: (B, S, D); b, c: (B, S, N); a: (D, N); h0: (B, D, N) float32,
    or None for zeros. All arithmetic in float32. Returns (y float32
    (B, S, D), h_last float32 (B, D, N))."""
    bsz, s, d = dt.shape
    n = b.shape[-1]
    dtf, xf, bf, cf = (t.to(torch.float32) for t in (dt, x, b, c))
    af = a.to(torch.float32)
    h = (torch.zeros((bsz, d, n), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.to(torch.float32))
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dt.device)
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * af)
        h = h * da + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, cf[:, t])
    return y, h


def wkv6_bwd_ref(r, k, v, w, u, dy, s0=None, ds_last=None, *, chunk=64):
    """The gradient of ``wkv6_ref``, written out in float32: from the
    inputs, the output's gradient dy (B, S, H, hd) and the final state's
    ds_last (B, H, hd, hd) or None (zeros), returns (dr, dk, dv in r's
    dtype, dw (B, S, H, hd), du (H, hd), ds0 (B, H, hd, hd) or None when
    s0 is None), all but the first three float32. With S_t the state
    before step t and G = dL/dS after it (G = ds_last after the last step):

        dr_t = S_t dy_t + u k_t (v_t . dy_t)
        dk_t = G v_t + u r_t (v_t . dy_t)
        dv_t = G^T k_t + (r_t . u k_t) dy_t
        dw_t[i] = sum_j G[i, j] S_t[i, j]
        du = sum over b and t of r_t k_t (v_t . dy_t)
        G <- diag(w_t) G + r_t dy_t^T             (dL/dS_t)

    and ds0 is G after step 0. The forward runs once, keeping the state
    every ``chunk`` steps; the reverse walk recomputes each chunk's states
    from its checkpoint (never S_t from S_(t+1) by dividing by w_t, which
    underflows to 0)."""
    b, s, h, hd = r.shape
    rf, kf, vf, wf, dyf = (t.to(torch.float32) for t in (r, k, v, w, dy))
    uf = u.to(torch.float32)
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
             if s0 is None else s0.to(torch.float32))
    checkpoints = []
    for t in range(s):
        if t % chunk == 0:
            checkpoints.append(state)
        state = wf[:, t, :, :, None] * state + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    g = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if ds_last is None else ds_last.to(torch.float32).clone())
    vdy = (vf * dyf).sum(dim=-1, keepdim=True)           # (B, S, H, 1)
    ruk = (rf * uf * kf).sum(dim=-1, keepdim=True)
    dr, dk, dv, dw = (torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
                      for _ in range(4))
    du = torch.zeros((b, h, hd), dtype=torch.float32, device=r.device)
    for c0 in reversed(range(0, s, chunk)):
        c1 = min(c0 + chunk, s)
        states = [checkpoints[c0 // chunk]]
        for t in range(c0, c1 - 1):
            states.append(wf[:, t, :, :, None] * states[-1]
                          + kf[:, t, :, :, None] * vf[:, t, :, None, :])
        for t in reversed(range(c0, c1)):
            st = states[t - c0]
            dr[:, t] = torch.einsum("bhij,bhj->bhi", st, dyf[:, t]) + uf * kf[:, t] * vdy[:, t]
            dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vf[:, t]) + uf * rf[:, t] * vdy[:, t]
            dv[:, t] = torch.einsum("bhij,bhi->bhj", g, kf[:, t]) + ruk[:, t] * dyf[:, t]
            dw[:, t] = (g * st).sum(dim=-1)
            du += rf[:, t] * kf[:, t] * vdy[:, t]
            g = wf[:, t, :, :, None] * g + rf[:, t, :, :, None] * dyf[:, t, :, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du.sum(dim=0),
            None if s0 is None else g)


def mamba_scan_bwd_ref(dt, x, b, c, a, dy, h0=None, dh_last=None, *, chunk=64):
    """The gradient of ``mamba_scan_ref``, written out in float32: from the
    inputs, the output's gradient dy (B, S, D) and the final state's
    dh_last (B, D, N) or None (zeros), returns (ddt (B, S, D), dx in x's
    dtype, db, dc (B, S, N), da (D, N), dh0 (B, D, N) or None when h0 is
    None), all but dx float32. With e_t = exp(dt_t a), h_t the state after
    step t and G = dL/dh_t (G = dh_last after the last step), walking t
    down:

        G += dy_t c_t
        dc_t[n] = sum_d h_t dy_t
        db_t[n] = sum_d G dt_t x_t
        dx_t = dt_t sum_n G b_t
        ddt_t = sum_n G (a e_t h_(t-1) + x_t b_t)
        da += G dt_t e_t h_(t-1)              (summed over b and t)
        G <- e_t G                            (dL/dh_(t-1))

    and dh0 is G after step 0. The forward runs once, keeping the state
    every ``chunk`` steps; the reverse walk recomputes each chunk's states
    from its checkpoint. A decay that underflows to 0 passes no gradient
    back, and every gradient stays finite."""
    bsz, s, d = dt.shape
    n = b.shape[-1]
    dtf, xf, bf, cf, dyf = (t.to(torch.float32) for t in (dt, x, b, c, dy))
    af = a.to(torch.float32)
    h = (torch.zeros((bsz, d, n), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.to(torch.float32))
    checkpoints = []
    for t in range(s):
        if t % chunk == 0:
            checkpoints.append(h)
        h = (h * torch.exp(dtf[:, t, :, None] * af)
             + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :])
    g = (torch.zeros((bsz, d, n), dtype=torch.float32, device=dt.device)
         if dh_last is None else dh_last.to(torch.float32).clone())
    ddt, dx = (torch.empty((bsz, s, d), dtype=torch.float32, device=dt.device)
               for _ in range(2))
    db, dc = (torch.empty((bsz, s, n), dtype=torch.float32, device=dt.device)
              for _ in range(2))
    da = torch.zeros((bsz, d, n), dtype=torch.float32, device=dt.device)
    for c0 in reversed(range(0, s, chunk)):
        c1 = min(c0 + chunk, s)
        states = [checkpoints[c0 // chunk]]
        for t in range(c0, c1 - 1):
            states.append(states[-1] * torch.exp(dtf[:, t, :, None] * af)
                          + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :])
        for t in reversed(range(c0, c1)):
            h_prev = states[t - c0]
            e = torch.exp(dtf[:, t, :, None] * af)
            u = dtf[:, t] * xf[:, t]
            h_t = h_prev * e + u[:, :, None] * bf[:, t, None, :]
            g = g + dyf[:, t, :, None] * cf[:, t, None, :]
            dc[:, t] = torch.einsum("bdn,bd->bn", h_t, dyf[:, t])
            db[:, t] = torch.einsum("bdn,bd->bn", g, u)
            dx[:, t] = dtf[:, t] * torch.einsum("bdn,bn->bd", g, bf[:, t])
            ddt[:, t] = (g * (af * e * h_prev + xf[:, t, :, None] * bf[:, t, None, :])).sum(-1)
            da += g * dtf[:, t, :, None] * e * h_prev
            g = g * e
    return ddt, dx.to(x.dtype), db, dc, da.sum(dim=0), None if h0 is None else g


def swiglu_ref(x, w_gate, w_up, w_down):
    """The SwiGLU FFN ``down(silu(x Wg) * (x Wu))`` in x's dtype
    (``repro.kernels.ref.swiglu_ref``, which is ``layers.swiglu``). The TPU
    kernel and the CUDA kernel compute it in float32 from the inputs
    widened, and return x's dtype: give this version float32 inputs to
    compute theirs."""
    return layers.swiglu(x, w_gate, w_up, w_down)


def fed_agg_ref(stacked: torch.Tensor, weights: torch.Tensor, *,
                groups: int = 1) -> torch.Tensor:
    """Weighted sum over the leading learner axis, accumulated in float32
    and returned in the input dtype (``repro.kernels.ref.fed_agg_ref``).
    With ``groups=G`` the N = G K learners are G groups of K consecutive
    ones, each summed into its own (G, ...) output."""
    w = weights.to(torch.float32).reshape((-1,) + (1,) * (stacked.dim() - 1))
    if groups == 1:
        return (stacked.to(torch.float32) * w).sum(dim=0).to(stacked.dtype)
    prod = stacked.to(torch.float32) * w
    return prod.reshape((groups, stacked.shape[0] // groups) + stacked.shape[1:]).sum(
        dim=1).to(stacked.dtype)


def _start_models(disp, n: int):
    """Every leaf of ``disp`` with a leading axis of the ``n`` learners:
    as it is, or, for a leaf with one model a group of learners (G rows),
    each row repeated for its group's n / G learners."""
    return [{name: leaf if leaf.shape[0] == n else leaf.repeat_interleave(
                n // leaf.shape[0], dim=0)
             for name, leaf in layer.items()} for layer in disp]


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order, one rounded add at a time:
    the order of the CUDA kernel, and of the reference's CPU program for
    the fleet sizes it runs (torch's ``sum`` would pair the terms up)."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def waterfill_residual_ref(tau_star, c2, c1, c0, T, d_lo, d_hi, total):
    """Batched KKT water-filling residual
    ``sum_k clip((T - c0) / (c2 tau* + c1), d_lo, d_hi) - total``
    (``repro.kernels.ref.waterfill_residual_ref``, summed in index order).
    tau_star/T/total: (B,); c2/c1/c0/d_lo/d_hi: (B, K). Returns (B,)."""
    d = torch.clamp((T[:, None] - c0) / (c2 * tau_star[:, None] + c1), d_lo, d_hi)
    return sum_in_order(d) - total


def waterfill_energy_residual_ref(tau_star, c2, c1, c0, T, e2, e1, e0, eb, d_lo, d_hi,
                                  total):
    """Energy-budgeted water-filling residual (arXiv 2012.00143): each
    learner absorbs the tighter of the deadline hyperbola
    ``(T - c0) / (c2 tau* + c1)`` and the budget hyperbola
    ``(eb - e0) / (e2 tau* + e1)``, clipped into its box, summed in index
    order (``repro.kernels.ref.waterfill_energy_residual_ref``). The time
    branch repeats ``waterfill_residual_ref`` operation for operation, and
    ``min(d_time, inf)`` is ``d_time``, so ``eb = +inf`` rows give the
    time-only residual bitwise; ``torch.minimum`` keeps a NaN of either
    side. tau_star/T/total: (B,); the coefficient rows, ``eb`` and the
    bounds: (B, K). Returns (B,)."""
    dt = (T[:, None] - c0) / (c2 * tau_star[:, None] + c1)
    de = (eb - e0) / (e2 * tau_star[:, None] + e1)
    return sum_in_order(torch.clamp(torch.minimum(dt, de), d_lo, d_hi)) - total


def accum_flush_ref(locals_, weights, acc, server, keep, flush):
    """The async epilogue of the train+aggregate step on one leaf:
    ``acc1 = fed_agg_ref([acc, locals_], [1, w])``,
    ``server' = fed_agg_ref([server, acc1], [keep, flush])`` and
    ``acc' = (1 - flush) * acc1``. locals_: (K, ...); weights: (K,);
    acc, server: (...); keep, flush: host scalars. Returns
    ``(server', acc')``."""
    dev = locals_.device
    w = torch.cat([torch.ones(1, dtype=torch.float32, device=dev),
                   weights.to(torch.float32)])
    acc1 = fed_agg_ref(torch.cat([acc[None], locals_]), w)
    kf = torch.tensor([float(keep), float(flush)], dtype=torch.float32, device=dev)
    server1 = fed_agg_ref(torch.stack([server, acc1]), kf)
    return server1, (1.0 - kf[1]) * acc1


def train_agg_step_ref(disp, x, y, m, tau, weights, lr, *, max_tau: int,
                       loss_fn=mlp.loss, groups: int = 1, server=None, acc=None,
                       keep=None, flush=None):
    """The train+aggregate step, unfused: ``local_train_stacked``
    (``tau_k`` masked GD steps per learner from its own parameters), then
    on every leaf either ``fed_agg_ref`` of the trained learners (cycle
    form, ``acc=None``; with ``groups=G``, one aggregate for each of G
    groups of consecutive learners, whose start models ``disp`` may hold
    one a group, see ``_start_models``) or ``accum_flush_ref`` (async form,
    with ``server``, ``acc``, ``keep`` and ``flush``). Returns
    ``(new_server, new_acc)``, ``new_acc=None`` in cycle form
    (``repro.kernels.ref.train_agg_step_ref``)."""
    from repro_torch.fed.orchestrator import local_train_stacked

    locals_ = local_train_stacked(_start_models(disp, x.shape[0]), x, y, m, tau, lr,
                                  max_tau=max_tau, loss_fn=loss_fn)
    w = weights.to(torch.float32)
    if acc is None:
        return [{name: fed_agg_ref(leaf, w, groups=groups) for name, leaf in layer.items()}
                for layer in locals_], None
    pairs = [{name: accum_flush_ref(leaf, w, acc[l][name], server[l][name], keep, flush)
              for name, leaf in layer.items()} for l, layer in enumerate(locals_)]
    return ([{name: p[0] for name, p in layer.items()} for layer in pairs],
            [{name: p[1] for name, p in layer.items()} for layer in pairs])

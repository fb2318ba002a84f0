"""CTC loss in the JAX package's signature and conventions
(``ops/ctc_loss.py``): [B, T, V] log-probs, blank 0, per-example negative
log likelihood [B] in f32, differentiated with respect to the log-probs
themselves, as ``jax.grad`` of the JAX function is.

The JAX loss is a log-semiring ``lax.scan`` (floor -1e30, its own
``_logaddexp``), not a Pallas kernel. On the card the port runs its own
kernel, ``jl_ctc_loss`` (``csrc/ctc_loss.cu``): the alpha recursion forward;
backward, the occupancy carried back through the recursion as the scan's
autodiff carries it (weights from the logaddexps' input differences, so
the long sums of log space never cancel) and the dense gradient; nothing is
read back to the host, so the loss sits inside a captured train step.
``ctc_forward_plain`` / ``ctc_backward_plain`` are the same recursions in
torch ops, looped over the frames (the scan's twin); the wrappers
``ctc_forward`` / ``ctc_backward`` take them only for tensors on the CPU,
and ``kernels=False`` takes them on any device (the plain path a kernel
run is compared with). ``CTCLoss`` is the ``torch.autograd.Function`` that
ties the two directions together.

One convention is the port's: a pair whose label needs more frames than it
has (labels plus one blank between each repeated pair) returns NLL 1e30,
the JAX recursion's floor negated, with a zero gradient (the JAX gradient
of that floor is not meaningful).
"""

from __future__ import annotations

import torch

from .._build import LaunchCounter, launch

INFEASIBLE_NLL = 1e30  # the JAX recursion's floor, negated
NEG_INF = -1e30  # the JAX recursion's floor

COUNTER = LaunchCounter("ctc_loss")  # jl_ctc_loss_fwd
BWD_COUNTER = LaunchCounter("ctc_loss_backward")  # jl_ctc_loss_bwd, two launches a call


def _lae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX module's _logaddexp: floored at NEG_INF, so two floors stay
    the floor and never give nan."""
    mx = torch.maximum(a, b).clamp_min(NEG_INF)
    return mx + torch.log1p(torch.exp(torch.minimum(a, b) - mx))


def _rows(labels, logit_lengths, label_lengths, T: int, blank_id: int):
    """-> (extended labels [B, U], skip allowed [B, U], valid state [B, U],
    label lengths, the last frame that counts [B], feasible [B])."""
    B, S = labels.shape
    U = 2 * S + 1
    dev = labels.device
    L = label_lengths.long().clamp(0, S)
    Tl = logit_lengths.long().clamp(0, T)
    ext = torch.full((B, U), blank_id, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    same = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=dev),
                      labels[:, 1:] == labels[:, :-1]], dim=1)
    skip = torch.zeros(B, U, dtype=torch.bool, device=dev)
    skip[:, 1::2] = ~same[:, :S]
    valid = torch.arange(U, device=dev)[None, :] < (2 * L + 1)[:, None]
    inside = torch.arange(S, device=dev)[None, :] < L[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & inside[:, 1:]).sum(1) if S > 1 else 0
    return ext, skip, valid, L, Tl.clamp_min(1) - 1, Tl >= L + repeats


def _neg(like: torch.Tensor, n: int) -> torch.Tensor:
    return like.new_full((like.shape[0], n), NEG_INF)


def ctc_forward_plain(lp, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """-> (nll [B], alpha [B, T, U], ll [B]) in f32: the JAX scan step by
    step (frames past a row's length carry alpha through). ll is NEG_INF
    for an infeasible row, whose nll is INFEASIBLE_NLL."""
    B, T, V = lp.shape
    ext, skip, valid, L, _, feasible = _rows(labels, logit_lengths, label_lengths, T, blank_id)
    U = ext.shape[1]
    emit = lp.float().gather(2, ext.clamp(0, V - 1)[:, None, :].expand(B, T, U))
    Tl = logit_lengths.long().clamp(0, T)
    a = _neg(emit[:, 0], U)
    a[:, 0] = emit[:, 0, 0]
    a[:, 1] = torch.where(L > 0, emit[:, 0, 1], NEG_INF)
    alpha = [a]
    for t in range(1, T):
        p1 = torch.cat([_neg(a, 1), a[:, :-1]], dim=1)
        p2 = torch.where(skip, torch.cat([_neg(a, 2), a[:, :-2]], dim=1), NEG_INF)
        new = torch.where(valid, _lae(_lae(a, p1), p2) + emit[:, t], NEG_INF)
        a = torch.where((t < Tl)[:, None], new, a)
        alpha.append(a)
    last = a.gather(1, (2 * L)[:, None])[:, 0]
    prev = torch.where(L > 0, a.gather(1, (2 * L - 1).clamp_min(0)[:, None])[:, 0], NEG_INF)
    ll = _lae(last, prev)
    nll = torch.where(feasible, -ll, torch.full_like(ll, INFEASIBLE_NLL))
    return nll, torch.stack(alpha, dim=1), torch.where(feasible, ll, torch.full_like(ll, NEG_INF))


def _lae_weights(a: torch.Tensor, b: torch.Tensor):
    """d _lae(a, b) / da and / db as jax.grad takes them: from x = exp(min
    - max), x / (1 + x) to the smaller input, 1 - x / (1 + x) to the
    larger, a half each on a tie."""
    mx = torch.maximum(a, b).clamp_min(NEG_INF)
    x = torch.exp(torch.minimum(a, b) - mx)
    small = x / (1.0 + x)
    large = 1.0 - small
    half = torch.full_like(small, 0.5)
    wa = torch.where(a > b, large, torch.where(a < b, small, half))
    wb = torch.where(a > b, small, torch.where(a < b, large, half))
    return wa, wb


def ctc_backward_plain(lp, logit_lengths, labels, label_lengths, alpha, ll, grad_nll,
                       blank_id: int = 0):
    """-> d(sum grad_nll * nll) / d log_probs [B, T, V] f32: the occupancy
    gamma[t, u] = d ll / d alpha[t, u], carried back from each row's last
    frame as jax.grad carries it through the scan (each state's share of
    the logaddexps that fed the next frame, weighted from their inputs'
    differences), and minus it summed over the states of each label; zero
    on frames past a row's length, on labels it does not hold and on
    infeasible rows."""
    B, T, V = lp.shape
    ext, skip, valid, L, tlast, _ = _rows(labels, logit_lengths, label_lengths, T, blank_id)
    U = ext.shape[1]
    rows = torch.arange(B, device=lp.device)
    live = (ll > NEG_INF)[:, None]
    last = alpha[rows, tlast]  # [B, U]
    a_last = last.gather(1, (2 * L)[:, None])[:, 0]
    a_prev = torch.where(L > 0, last.gather(1, (2 * L - 1).clamp_min(0)[:, None])[:, 0], NEG_INF)
    w_last, w_prev = _lae_weights(a_last, a_prev)
    u = torch.arange(U, device=lp.device)[None, :]
    term = torch.where(u == (2 * L)[:, None], w_last[:, None], 0.0)
    term = torch.where((L[:, None] > 0) & (u == (2 * L - 1)[:, None]), w_prev[:, None], term)
    term = torch.where(live, term, 0.0)
    zero = torch.zeros(B, 1, dtype=torch.float32, device=lp.device)
    adj = torch.zeros(B, U, dtype=torch.float32, device=lp.device)
    gammas = [None] * T
    for t in range(T - 1, -1, -1):
        a = alpha[:, t]
        p1 = torch.cat([_neg(a, 1), a[:, :-1]], dim=1)
        p2 = torch.where(skip, torch.cat([_neg(a, 2), a[:, :-2]], dim=1), NEG_INF)
        ws, w1 = _lae_weights(a, p1)
        wi, w2 = _lae_weights(_lae(a, p1), p2)
        adj_v = torch.where(valid, adj, 0.0)  # frame t + 1's, by the state it feeds
        c0, c1 = adj_v * (wi * ws), adj_v * (wi * w1)
        c2 = torch.where(skip, adj_v * w2, 0.0)
        back = (c0 + torch.cat([c1[:, 1:], zero], dim=1)
                + torch.cat([c2[:, 2:], zero, zero], dim=1))
        adj = torch.where((t == tlast)[:, None], term,
                          torch.where((t < tlast)[:, None] & valid, back, 0.0))
        gammas[t] = adj
    gamma = torch.stack(gammas, dim=1)  # [B, T, U]
    grad = torch.zeros(B, T, V, dtype=torch.float32, device=lp.device)
    weight = -grad_nll.float()[:, None, None] * gamma
    return grad.scatter_add_(2, ext.clamp(0, V - 1)[:, None, :].expand(B, T, U), weight)


def _kernel_args(lp, logit_lengths, labels, label_lengths):
    """Raise unless the operands are the kernel's -> int32 contiguous
    labels and lengths on lp's device."""
    if lp.device.type != "cuda":
        raise ValueError(f"jl_ctc_loss: expected CUDA tensors, got {lp.device}")
    if lp.dtype != torch.float32 or lp.dim() != 3 or not lp.is_contiguous():
        raise ValueError(f"jl_ctc_loss: expected contiguous f32 [B, T, V] log-probs, got "
                         f"{lp.dtype} {tuple(lp.shape)}")
    B = lp.shape[0]
    if labels.dim() != 2 or labels.shape[0] != B:
        raise ValueError(f"jl_ctc_loss: labels {tuple(labels.shape)} do not match B={B}")
    out = [t.to(device=lp.device, dtype=torch.int32).contiguous()
           for t in (labels, logit_lengths, label_lengths)]
    if out[1].shape != (B,) or out[2].shape != (B,):
        raise ValueError("jl_ctc_loss: lengths must be [B]")
    return out


def ctc_forward(lp, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """jl_ctc_loss_fwd wrapper -> (nll, alpha, ll), as ctc_forward_plain.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous f32 log-probs) or raise."""
    if lp.device.type == "cpu":
        return ctc_forward_plain(lp, logit_lengths, labels, label_lengths, blank_id)
    lab, tlen, llen = _kernel_args(lp, logit_lengths, labels, label_lengths)
    B, T, V = lp.shape
    S = lab.shape[1]
    alpha = torch.empty(B, T, 2 * S + 1, device=lp.device, dtype=torch.float32)
    nll = torch.empty(B, device=lp.device, dtype=torch.float32)
    ll = torch.empty_like(nll)
    launch("jl_ctc_loss_fwd", lp.data_ptr(), lab.data_ptr(), tlen.data_ptr(), llen.data_ptr(),
           alpha.data_ptr(), nll.data_ptr(), ll.data_ptr(), B, T, V, S, blank_id)
    COUNTER.launches += 1
    return nll, alpha, ll


def ctc_backward(lp, logit_lengths, labels, label_lengths, alpha, ll, grad_nll,
                 blank_id: int = 0):
    """jl_ctc_loss_bwd wrapper -> the dense gradient [B, T, V], as
    ctc_backward_plain. CPU tensors take the plain version; CUDA tensors
    launch the two kernels or raise. `alpha` is overwritten (the occupancy)."""
    if lp.device.type == "cpu":
        return ctc_backward_plain(lp, logit_lengths, labels, label_lengths, alpha, ll, grad_nll,
                                  blank_id)
    lab, tlen, llen = _kernel_args(lp, logit_lengths, labels, label_lengths)
    B, T, V = lp.shape
    S = lab.shape[1]
    if alpha.shape != (B, T, 2 * S + 1) or not alpha.is_contiguous() or ll.shape != (B,):
        raise ValueError("jl_ctc_loss: alpha / ll do not match the log-probs")
    g = grad_nll.to(torch.float32).expand(B).contiguous()
    head = torch.empty(B, V, device=lp.device, dtype=torch.int32)
    nxt = torch.empty(B, 2 * S + 1, device=lp.device, dtype=torch.int32)
    grad = torch.empty(B, T, V, device=lp.device, dtype=torch.float32)
    launch("jl_ctc_loss_bwd", lp.data_ptr(), lab.data_ptr(), tlen.data_ptr(), llen.data_ptr(),
           alpha.data_ptr(), ll.data_ptr(), g.data_ptr(), head.data_ptr(), nxt.data_ptr(),
           grad.data_ptr(), B, T, V, S, blank_id)
    BWD_COUNTER.launches += 1
    return grad


class CTCLoss(torch.autograd.Function):
    """nll = ctc(log_probs); the forward saves alpha and ll, the backward
    is the beta pass. With ``kernels=False`` both directions take the plain
    versions."""

    @staticmethod
    def forward(ctx, lp, logit_lengths, labels, label_lengths, blank_id, kernels):
        fwd = ctc_forward if kernels else ctc_forward_plain
        nll, alpha, ll = fwd(lp, logit_lengths, labels, label_lengths, blank_id)
        ctx.save_for_backward(lp, logit_lengths, labels, label_lengths, alpha, ll)
        ctx.blank_id, ctx.kernels = blank_id, kernels
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        lp, logit_lengths, labels, label_lengths, alpha, ll = ctx.saved_tensors
        bwd = ctc_backward if ctx.kernels else ctc_backward_plain
        grad = bwd(lp, logit_lengths, labels, label_lengths, alpha, ll, grad_nll, ctx.blank_id)
        return grad, None, None, None, None, None


def ctc_loss(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0, kernels: bool = True) -> torch.Tensor:
    """-> per-example NLL [B] (float32); differentiable with respect to
    log_probs through CTCLoss."""
    lp = log_probs.float().contiguous()
    dev = lp.device
    args = (logit_lengths.to(dev), labels.to(dev), label_lengths.to(dev))
    if torch.is_grad_enabled() and lp.requires_grad:
        return CTCLoss.apply(lp, *args, blank_id, kernels)
    return (ctc_forward if kernels else ctc_forward_plain)(lp, *args, blank_id)[0]


def ctc_loss_mean(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """The batch mean of each NLL over its label length (at least 1): the
    JAX function, ``F.ctc_loss(reduction="mean")``'s normalisation."""
    nll = ctc_loss(log_probs, logit_lengths, labels, label_lengths, blank_id)
    return (nll / label_lengths.to(nll.device).clamp_min(1).float()).mean()

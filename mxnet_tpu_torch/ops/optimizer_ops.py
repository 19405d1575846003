"""Optimizer update operators — the port of
``mxnet_tpu/ops/optimizer_ops.py``: the 20 registry ops (``sgd_update``,
``adam_update``, ..., ``multi_mp_sgd_mom_update``, ``lars_update``), so
``mx.nd.sgd_update(w, g, lr=0.5, out=w)`` writes into its outputs as the
reference does.

Each optimizer's arithmetic is written once here, as an in-place update of
lists of tensors in ``torch._foreach_*`` library math (one pass over all
parameters of a dtype); ``optimizer.py``'s classes call these functions
over every parameter at once, and each registered op calls the same
function on copies of its one set of inputs and returns them.  Scalars
that differ per parameter (learning rate, weight decay, the step count)
come as lists with one entry per tensor.  The norms of LARS and LAMB are
``torch._foreach_norm`` on the device, never a host read per tensor.

The scalars that change from step to step (each tensor's learning rate,
the step count ``t`` of LAMB's bias correction, ``rescale_grad``) may be
Python numbers or 0-d tensors on the device (``parallel.TrainStep``
writes them there before each step, so a captured CUDA graph reads the
step's values); no formula reads such a tensor back to the host.  Tensors
that share one such scalar object are scaled by one ``_foreach_*`` call
(its 0-d tensor overload), so a rate shared by every parameter costs what
a Python number does.  The rest (weight decay, momentum, betas, epsilon,
clipping) are Python numbers.

The formulas, with g = clip(rescale_grad * grad, +-clip_gradient):

- sgd: w -= lr (g + wd w); with momentum m = momentum m - lr (g + wd w),
  w += m
- nag: g += wd w; m = momentum m + g; w -= lr (g + momentum m)
- adam: g += wd w; m, v moving averages; w -= lr m / (sqrt(v) + eps)
  (the optimizer folds the bias correction into lr)
- adamw: m, v of g; w -= eta (lr m / (sqrt(v) + eps) + wd w)
- rmsprop: g += wd w; n = g1 n + (1 - g1) g^2; w -= lr g / sqrt(n + eps);
  centered (rmspropalex): also g_avg, and delta = g2 delta
  - lr g / sqrt(n - g_avg^2 + eps), w += delta
- ftrl, signsgd/signum, lamb (phase 1: the bias-corrected step plus wd w;
  phase 2: w -= lr r1/r2 step with r1 = ||w||, r2 = ||step||), adagrad,
  adadelta and lars (lr scaled by eta ||w|| / (||g|| + wd ||w|| + eps))
  as in the reference, line for line.
"""

from __future__ import annotations

import torch

from .registry import register


def _prep(grads, rescale_grad, clip_gradient):
    """clip(rescale_grad * grad, +-clip_gradient), as new tensors."""
    if isinstance(rescale_grad, torch.Tensor):
        # the 0-d overload runs as one kernel only in the tensors' dtype
        rescale_grad = rescale_grad.to(grads[0].dtype)
    g = torch._foreach_mul(grads, rescale_grad)
    if clip_gradient is not None and clip_gradient >= 0:
        torch._foreach_clamp_min_(g, -clip_gradient)
        torch._foreach_clamp_max_(g, clip_gradient)
    return g


def _add_wd(g, weights, wds):
    """g += wd * w, per tensor."""
    if any(wds):
        torch._foreach_add_(g, torch._foreach_mul(weights, wds))


def _per_scalar(fn, scalars, *others):
    """[fn(s, *o)] over the per-tensor ``scalars`` (and Python ``others``),
    computed once per distinct device scalar and its others, so tensors
    that shared a scalar share the result."""
    memo, out = {}, []
    for s, *o in zip(scalars, *others):
        if not isinstance(s, torch.Tensor):
            out.append(fn(s, *o))
            continue
        key = (id(s), *o)
        if key not in memo:
            memo[key] = fn(s, *o)
        out.append(memo[key])
    return out


def _neg(xs):
    return _per_scalar(lambda x: -x, xs)


def _by_scalar(op, xs, scalars):
    """``op(xs, scalars)`` for a ``torch._foreach_*`` binary op: Python
    numbers in one scalar-list call; device scalars one call per distinct
    scalar over the tensors that share it, the scalar cast to their dtype
    (as a Python number is: torch's 0-d overload is one kernel only in the
    tensors' dtype, else one per tensor).  Returns the out-of-place op's
    results in ``xs``' order."""
    if not isinstance(scalars[0], torch.Tensor):
        return op(xs, scalars)
    groups = {}
    for pos, sc in enumerate(scalars):
        groups.setdefault(id(sc), (sc, []))[1].append(pos)
    out = [None] * len(xs)
    for sc, pos in groups.values():
        res = op([xs[p] for p in pos], sc.to(xs[pos[0]].dtype))
        for p, r in zip(pos, res or ()):
            out[p] = r
    return out


def _addcdiv_(xs, num, den, scales):
    """xs += scale * num / den per tensor.  With device-tensor scales it
    divides, scales and adds: ``_foreach_addcdiv_``'s tensor overload would
    read the scales back to the host."""
    if isinstance(scales[0], torch.Tensor):
        q = torch._foreach_div(num, den)
        _by_scalar(torch._foreach_mul_, q, scales)
        torch._foreach_add_(xs, q)
    else:
        torch._foreach_addcdiv_(xs, num, den, scales)


# -- the formulas: in place over lists of tensors ---------------------------

def sgd(weights, grads, moms, lrs, wds, momentum=0.0, rescale_grad=1.0,
        clip_gradient=-1.0):
    """SGD, with momentum when ``moms`` is a list."""
    g = _prep(grads, rescale_grad, clip_gradient)
    _add_wd(g, weights, wds)
    _by_scalar(torch._foreach_mul_, g, _neg(lrs))
    if moms is None:
        torch._foreach_add_(weights, g)
        return
    torch._foreach_mul_(moms, momentum)
    torch._foreach_add_(moms, g)
    torch._foreach_add_(weights, moms)


def nag(weights, grads, moms, lrs, wds, momentum=0.0, rescale_grad=1.0,
        clip_gradient=-1.0):
    g = _prep(grads, rescale_grad, clip_gradient)
    _add_wd(g, weights, wds)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_add_(moms, g)
    torch._foreach_add_(g, torch._foreach_mul(moms, momentum))
    _by_scalar(torch._foreach_mul_, g, _neg(lrs))
    torch._foreach_add_(weights, g)


def adam(weights, grads, means, variances, lrs, wds, beta1=0.9, beta2=0.999,
         epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grads, rescale_grad, clip_gradient)
    _add_wd(g, weights, wds)
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, g, alpha=1.0 - beta1)
    torch._foreach_mul_(variances, beta2)
    torch._foreach_addcmul_(variances, g, g, value=1.0 - beta2)
    del g
    denom = torch._foreach_sqrt(variances)
    torch._foreach_add_(denom, epsilon)
    _addcdiv_(weights, means, denom, _neg(lrs))


def adamw(weights, grads, means, variances, lrs, wds, beta1=0.9,
          beta2=0.999, epsilon=1e-8, eta=1.0, rescale_grad=1.0,
          clip_gradient=-1.0):
    g = _prep(grads, rescale_grad, clip_gradient)
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, g, alpha=1.0 - beta1)
    torch._foreach_mul_(variances, beta2)
    torch._foreach_addcmul_(variances, g, g, value=1.0 - beta2)
    del g
    denom = torch._foreach_sqrt(variances)
    torch._foreach_add_(denom, epsilon)
    step = torch._foreach_div(means, denom)
    _by_scalar(torch._foreach_mul_, step, lrs)
    _add_wd(step, weights, wds)
    torch._foreach_add_(weights, step, alpha=-eta)


def _clip_weights(weights, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        torch._foreach_clamp_min_(weights, -clip_weights)
        torch._foreach_clamp_max_(weights, clip_weights)


def rmsprop(weights, grads, ns, lrs, wds, gamma1=0.9, epsilon=1e-8,
            rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep(grads, rescale_grad, clip_gradient)
    _add_wd(g, weights, wds)
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_addcmul_(ns, g, g, value=1.0 - gamma1)
    denom = torch._foreach_add(ns, epsilon)
    torch._foreach_sqrt_(denom)
    _addcdiv_(weights, g, denom, _neg(lrs))
    _clip_weights(weights, clip_weights)


def rmspropalex(weights, grads, ns, g_avgs, deltas, lrs, wds, gamma1=0.9,
                gamma2=0.9, epsilon=1e-8, rescale_grad=1.0,
                clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep(grads, rescale_grad, clip_gradient)
    _add_wd(g, weights, wds)
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_addcmul_(ns, g, g, value=1.0 - gamma1)
    torch._foreach_mul_(g_avgs, gamma1)
    torch._foreach_add_(g_avgs, g, alpha=1.0 - gamma1)
    denom = torch._foreach_addcmul(ns, g_avgs, g_avgs, value=-1.0)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_mul_(deltas, gamma2)
    _addcdiv_(deltas, g, denom, _neg(lrs))
    torch._foreach_add_(weights, deltas)
    _clip_weights(weights, clip_weights)


def ftrl(weights, grads, zs, ns, lrs, wds, lamda1=0.01, beta=1.0,
         rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grads, rescale_grad, clip_gradient)
    sqrt_old = torch._foreach_sqrt(ns)
    torch._foreach_addcmul_(ns, g, g)
    sqrt_new = torch._foreach_sqrt(ns)
    sigma = torch._foreach_sub(sqrt_new, sqrt_old)
    _by_scalar(torch._foreach_div_, sigma, lrs)
    torch._foreach_add_(zs, g)
    torch._foreach_addcmul_(zs, sigma, weights, value=-1.0)
    # w = 0 where |z| <= lamda1, else -(z - sign(z) l1) / ((beta +
    # sqrt(n)) / lr + wd): a select, one tensor at a time
    for w, z, sq, lr, wd in zip(weights, zs, sqrt_new, lrs, wds):
        w.copy_(torch.where(z.abs() <= lamda1, torch.zeros_like(w),
                            -(z - torch.sign(z) * lamda1)
                            / ((beta + sq) / lr + wd)))


def signum(weights, grads, moms, lrs, wds, momentum=0.0, wd_lh=0.0,
           rescale_grad=1.0, clip_gradient=-1.0):
    """Signum, or signSGD when ``moms`` is None."""
    g = _prep(grads, rescale_grad, clip_gradient)
    if moms is None:
        s = torch._foreach_sign(g)
        _add_wd(s, weights, wds)
        _by_scalar(torch._foreach_mul_, s, _neg(lrs))
        torch._foreach_add_(weights, s)
        return
    torch._foreach_mul_(moms, momentum)
    torch._foreach_add_(moms, g, alpha=-(1.0 - momentum))
    s = torch._foreach_sign(moms)
    _by_scalar(torch._foreach_mul_, s, lrs)
    decay = _by_scalar(torch._foreach_mul, weights,
                       _per_scalar(lambda lr, wd: lr * wd, lrs, wds))
    if wd_lh:
        _by_scalar(torch._foreach_mul_, weights,
                   _per_scalar(lambda lr: 1.0 - lr * wd_lh, lrs))
    torch._foreach_add_(weights, s)
    torch._foreach_sub_(weights, decay)


def lamb_phase1(weights, grads, means, variances, wds, ts, beta1=0.9,
                beta2=0.999, epsilon=1e-6, bias_correction=True,
                rescale_grad=1.0, clip_gradient=-1.0):
    """The moving averages (in place) and the step, returned:
    m_hat / (sqrt(v_hat) + eps) + wd w, bias-corrected at step ``ts``."""
    g = _prep(grads, rescale_grad, clip_gradient)
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, g, alpha=1.0 - beta1)
    torch._foreach_mul_(variances, beta2)
    torch._foreach_addcmul_(variances, g, g, value=1.0 - beta2)
    del g
    if bias_correction:
        step = _by_scalar(torch._foreach_div, means,
                          _per_scalar(lambda t: 1.0 - beta1 ** t, ts))
        denom = _by_scalar(torch._foreach_div, variances,
                           _per_scalar(lambda t: 1.0 - beta2 ** t, ts))
    else:
        step = [m.clone() for m in means]
        denom = [v.clone() for v in variances]
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_div_(step, denom)
    _add_wd(step, weights, wds)
    return step


def _trust_ratio(r1, r2):
    """r1/r2 where both norms are positive, else 1 (tensors of norms)."""
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))


def lamb_phase2(weights, steps, r1s, r2s, lrs, lower_bound=-1.0,
                upper_bound=-1.0):
    """w -= lr * ratio * step with ratio = r1/r2 (r1 clipped to the
    bounds); ``r1s``/``r2s`` are 1-element tensors, one per weight."""
    r1 = torch.stack([r.reshape(()) for r in r1s])
    r2 = torch.stack([r.reshape(()) for r in r2s])
    if lower_bound is not None and lower_bound >= 0:
        r1 = r1.clamp(min=lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1 = r1.clamp(max=upper_bound)
    ratio = _trust_ratio(r1, r2).to(weights[0].dtype)
    torch._foreach_mul_(steps, list(ratio.unbind()))
    _by_scalar(torch._foreach_mul_, steps, _neg(lrs))
    torch._foreach_add_(weights, steps)


def lamb(weights, grads, means, variances, lrs, wds, ts, beta1=0.9,
         beta2=0.999, epsilon=1e-6, bias_correction=True, lower_bound=-1.0,
         upper_bound=-1.0, rescale_grad=1.0, clip_gradient=-1.0):
    steps = lamb_phase1(weights, grads, means, variances, wds, ts, beta1,
                        beta2, epsilon, bias_correction, rescale_grad,
                        clip_gradient)
    lamb_phase2(weights, steps, torch._foreach_norm(weights),
                torch._foreach_norm(steps), lrs, lower_bound, upper_bound)


def adagrad(weights, grads, histories, lrs, wds, epsilon=1e-7,
            rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grads, rescale_grad, clip_gradient)
    torch._foreach_addcmul_(histories, g, g)
    denom = torch._foreach_add(histories, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_div_(g, denom)
    _add_wd(g, weights, wds)
    _by_scalar(torch._foreach_mul_, g, _neg(lrs))
    torch._foreach_add_(weights, g)


def adadelta(weights, grads, acc_gs, acc_deltas, wds, rho=0.9, epsilon=1e-5,
             rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grads, rescale_grad, clip_gradient)
    torch._foreach_mul_(acc_gs, rho)
    torch._foreach_addcmul_(acc_gs, g, g, value=1.0 - rho)
    delta = torch._foreach_add(acc_deltas, epsilon)
    torch._foreach_sqrt_(delta)
    denom = torch._foreach_add(acc_gs, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_div_(delta, denom)
    torch._foreach_mul_(delta, g)
    torch._foreach_mul_(acc_deltas, rho)
    torch._foreach_addcmul_(acc_deltas, delta, delta, value=1.0 - rho)
    decay = torch._foreach_mul(weights, wds)
    torch._foreach_sub_(weights, delta)
    torch._foreach_sub_(weights, decay)


def lars(weights, grads, moms, lrs, wds, momentum=0.9, eta=0.001,
         epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0):
    """lr scaled per tensor by eta ||w|| / (||g|| + wd ||w|| + eps), or
    plain lr where a norm is 0; m = momentum m + lr' (g + wd w); w -= m."""
    g = _prep(grads, rescale_grad, clip_gradient)
    w_norm = torch._foreach_norm([w.float() for w in weights])
    g_norm = torch._foreach_norm([x.float() for x in g])
    denom = torch._foreach_mul(w_norm, wds)
    torch._foreach_add_(denom, g_norm)
    torch._foreach_add_(denom, epsilon)
    wn, gn = torch.stack(w_norm), torch.stack(g_norm)
    trust = torch.where((wn > 0) & (gn > 0),
                        eta * (wn / torch.stack(denom)), torch.ones_like(wn))
    _add_wd(g, weights, wds)
    torch._foreach_mul_(g, list(trust.to(g[0].dtype).unbind()))
    _by_scalar(torch._foreach_mul_, g, lrs)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_add_(moms, g)
    torch._foreach_sub_(weights, moms)


# -- the registry ops: each formula on copies of one set of inputs ----------

def _copies(*tensors):
    return [t.clone() for t in tensors]


_OPT = dict(differentiable=False)


@register("sgd_update", **_OPT)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=False):  # noqa: ARG001
    (w,) = _copies(weight)
    sgd([w], [grad], None, [lr], [wd], 0.0, rescale_grad, clip_gradient)
    return w


@register("sgd_mom_update", num_outputs=2, **_OPT)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0,
                    lazy_update=False):  # noqa: ARG001
    w, m = _copies(weight, mom)
    sgd([w], [grad], [m], [lr], [wd], momentum, rescale_grad, clip_gradient)
    return w, m


@register("nag_mom_update", num_outputs=2, **_OPT)
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    w, m = _copies(weight, mom)
    nag([w], [grad], [m], [lr], [wd], momentum, rescale_grad, clip_gradient)
    return w, m


@register("adam_update", num_outputs=3, **_OPT)
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=False):  # noqa: ARG001
    w, m, v = _copies(weight, mean, var)
    adam([w], [grad], [m], [v], [lr], [wd], beta1, beta2, epsilon,
         rescale_grad, clip_gradient)
    return w, m, v


@register("adamw_update", num_outputs=3, **_OPT)
def _adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                  epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    w, m, v = _copies(weight, mean, var)
    adamw([w], [grad], [m], [v], [lr], [wd], beta1, beta2, epsilon, eta,
          rescale_grad, clip_gradient)
    return w, m, v


@register("rmsprop_update", num_outputs=2, **_OPT)
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    w, n = _copies(weight, n)
    rmsprop([w], [grad], [n], [lr], [wd], gamma1, epsilon, rescale_grad,
            clip_gradient, clip_weights)
    return w, n


@register("rmspropalex_update", num_outputs=4, **_OPT)
def _rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001,
                        gamma1=0.9, gamma2=0.9, epsilon=1e-8, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0,
                        clip_weights=-1.0):
    w, n, g, d = _copies(weight, n, g_state, delta)
    rmspropalex([w], [grad], [n], [g], [d], [lr], [wd], gamma1, gamma2,
                epsilon, rescale_grad, clip_gradient, clip_weights)
    return w, n, g, d


@register("ftrl_update", num_outputs=3, **_OPT)
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    w, z, n = _copies(weight, z, n)
    ftrl([w], [grad], [z], [n], [lr], [wd], lamda1, beta, rescale_grad,
         clip_gradient)
    return w, z, n


@register("signsgd_update", **_OPT)
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    (w,) = _copies(weight)
    signum([w], [grad], None, [lr], [wd], 0.0, 0.0, rescale_grad,
           clip_gradient)
    return w


@register("signum_update", num_outputs=2, **_OPT)
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    w, m = _copies(weight, mom)
    signum([w], [grad], [m], [lr], [wd], momentum, wd_lh, rescale_grad,
           clip_gradient)
    return w, m


@register("lamb_update_phase1", **_OPT)
def _lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                        epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0):
    m, v = _copies(mean, var)
    return lamb_phase1([weight], [grad], [m], [v], [wd], [t], beta1, beta2,
                       epsilon, bias_correction, rescale_grad,
                       clip_gradient)[0]


@register("lamb_update_phase2", **_OPT)
def _lamb_update_phase2(weight, g_update, r1, r2, lr=0.01, lower_bound=-1.0,
                        upper_bound=-1.0):
    w, step = _copies(weight, g_update)
    lamb_phase2([w], [step], [r1], [r2], [lr], lower_bound, upper_bound)
    return w


@register("lamb_full_update", num_outputs=3, **_OPT)
def _lamb_full_update(weight, grad, mean, var, lr=0.01, beta1=0.9,
                      beta2=0.999, epsilon=1e-6, t=1, bias_correction=True,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lower_bound=-1.0, upper_bound=-1.0):
    w, m, v = _copies(weight, mean, var)
    lamb([w], [grad], [m], [v], [lr], [wd], [t], beta1, beta2, epsilon,
         bias_correction, lower_bound, upper_bound, rescale_grad,
         clip_gradient)
    return w, m, v


@register("adagrad_update", num_outputs=2, **_OPT)
def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    w, h = _copies(weight, history)
    adagrad([w], [grad], [h], [lr], [wd], epsilon, rescale_grad,
            clip_gradient)
    return w, h


@register("adadelta_update", num_outputs=3, **_OPT)
def _adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                     wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    w, ag, ad = _copies(weight, acc_g, acc_delta)
    adadelta([w], [grad], [ag], [ad], [wd], rho, epsilon, rescale_grad,
             clip_gradient)
    return w, ag, ad


@register("lars_update", num_outputs=2, **_OPT)
def _lars_update(weight, grad, mom, lr=0.01, momentum=0.9, eta=0.001,
                 wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 epsilon=1e-8):
    w, m = _copies(weight, mom)
    lars([w], [grad], [m], [lr], [wd], momentum, eta, epsilon, rescale_grad,
         clip_gradient)
    return w, m


# -- multi-tensor ops: N parameters in one call, lr/wd as input vectors ----
# The tensors come interleaved as in the reference (w0, g0, w1, g1, ...,
# lrs, wds); the outputs too.

def _groups(args, k, num_weights):
    lrs, wds = args[-2].tolist(), args[-1].tolist()
    flat = args[:-2]
    n = int(num_weights) or len(flat) // k
    return [flat[k * i:k * (i + 1)] for i in range(n)], lrs[:n], wds[:n]


@register("multi_sgd_update", num_outputs=-1, **_OPT)
def _multi_sgd_update(*args, rescale_grad=1.0, clip_gradient=-1.0,
                      num_weights=0):
    groups, lrs, wds = _groups(args, 2, num_weights)
    ws = [w.clone() for w, _ in groups]
    sgd(ws, [g for _, g in groups], None, lrs, wds, 0.0, rescale_grad,
        clip_gradient)
    return tuple(ws)


@register("multi_sgd_mom_update", num_outputs=-1, **_OPT)
def _multi_sgd_mom_update(*args, momentum=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0, num_weights=0):
    groups, lrs, wds = _groups(args, 3, num_weights)
    ws = [w.clone() for w, _, _ in groups]
    ms = [m.clone() for _, _, m in groups]
    sgd(ws, [g for _, g, _ in groups], ms, lrs, wds, momentum, rescale_grad,
        clip_gradient)
    return tuple(x for pair in zip(ws, ms) for x in pair)


@register("multi_mp_sgd_update", num_outputs=-1, **_OPT)
def _multi_mp_sgd_update(*args, rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=0):
    """(w, g, w32) triples: the update runs on the f32 masters and the
    weights are the masters rounded to their dtype."""
    groups, lrs, wds = _groups(args, 3, num_weights)
    w32 = [m.clone() for _, _, m in groups]
    sgd(w32, [g.to(m.dtype) for (_, g, _), m in zip(groups, w32)], None,
        lrs, wds, 0.0, rescale_grad, clip_gradient)
    return tuple(x for (w, _, _), m in zip(groups, w32)
                 for x in (m.to(w.dtype), m))


@register("multi_mp_sgd_mom_update", num_outputs=-1, **_OPT)
def _multi_mp_sgd_mom_update(*args, momentum=0.0, rescale_grad=1.0,
                             clip_gradient=-1.0, num_weights=0):
    """(w, g, m, w32) quadruples -> (w, m, w32) triples."""
    groups, lrs, wds = _groups(args, 4, num_weights)
    ms = [m.clone() for _, _, m, _ in groups]
    w32 = [x.clone() for _, _, _, x in groups]
    sgd(w32, [g.to(x.dtype) for (_, g, _, _), x in zip(groups, w32)], ms,
        lrs, wds, momentum, rescale_grad, clip_gradient)
    return tuple(x for (w, _, _, _), m, x32 in zip(groups, ms, w32)
                 for x in (x32.to(w.dtype), m, x32))

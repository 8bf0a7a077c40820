"""Optimizers: the port of ``mxnet_tpu/optimizer.py``.

The registry, update counts, lr/wd multipliers (from the symbol's
``__lr_mult__``/``__wd_mult__`` attributes), ``rescale_grad`` and
``clip_gradient`` follow the reference.  ``step_param(w, g, state, lr,
wd, t)`` is each optimizer's update rule on tensors; ``update`` applies
it in place on the NDArrays' tensors under ``torch.no_grad()``.  Adam's
step size is the reference's ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``
in float32, with epsilon outside the square root.
"""

from __future__ import annotations

import pickle

import torch

from . import random as _random
from .context import cpu
from .ndarray import zeros
from .registry import Registry

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "ccSGD", "Adam", "AdamW", "AdaGrad",
           "RMSProp", "AdaDelta", "Test", "LARS", "LAMB", "create",
           "get_updater", "register"]

OPT_REGISTRY = Registry("optimizer")
register = OPT_REGISTRY.register


def _state_leaves(state):
    """The tensors of an optimizer state (None / NDArray / tuple of
    NDArrays): what ``step_param`` operates on."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(s._data for s in state)
    return state._data


def _state_commit(state, new_leaves):
    """Write ``step_param``'s state tensors back into the NDArrays."""
    if state is None:
        return
    if isinstance(state, (tuple, list)):
        for s, v in zip(state, new_leaves):
            if v is not s._data:
                s._data.copy_(v)
    elif new_leaves is not state._data:
        state._data.copy_(new_leaves)


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class Optimizer:
    """Base optimizer (reference optimizer.py:20-233)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult = {}
        self.wd_mult = {}
        self.sym = sym
        if sym is not None:
            attrs = sym.attr_dict()
            for name in sym.list_arguments():
                a = attrs.get(name, {})
                if "__lr_mult__" in a:
                    self.lr_mult[name] = float(a["__lr_mult__"])
                if "__wd_mult__" in a:
                    self.wd_mult[name] = float(a["__wd_mult__"])

    # -- state -------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    # ``step_param`` is the update rule on tensors:
    #
    #   w, g           weight / gradient tensors
    #   state          state tensors (None / tensor / tuple of tensors,
    #                  matching ``create_state``'s structure)
    #   lr, wd, t      per-param learning rate, weight decay and update
    #                  count
    step_param = None  # overridden by every optimizer with a plain rule

    def update(self, index, weight, grad, state):
        """One per-parameter update, in place on the weight and state
        tensors."""
        if self.step_param is None:
            raise NotImplementedError(
                f"{type(self).__name__} defines neither step_param nor a "
                "custom update")
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        with torch.no_grad():
            w, new_state = self.step_param(weight._data, grad._data,
                                           _state_leaves(state), lr, wd, t)
            if w is not weight._data:
                weight._data.copy_(w)
            _state_commit(state, new_state)

    # -- multipliers / schedules (optimizer.py:120-233) ---------------------
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler else self.lr
        name = self.idx2name.get(index, index)
        if name in self.lr_mult:
            lr *= self.lr_mult[name]
        return lr

    def _get_wd(self, index):
        wd = self.wd
        name = self.idx2name.get(index, index)
        # bias / gamma / beta default to wd_mult 0 in reference Module flows
        if name in self.wd_mult:
            wd *= self.wd_mult[name]
        elif isinstance(name, str) and name.endswith(("_bias", "_gamma", "_beta")):
            wd *= 0.0
        return wd

    def _preprocess(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    @staticmethod
    def create_optimizer(name, rescale_grad=1.0, **kwargs):
        return OPT_REGISTRY.get(name)(rescale_grad=rescale_grad, **kwargs)

    @staticmethod
    def register(klass):
        """Register an optimizer class under its lowercased name
        (reference optimizer.py:17-28; usable as a decorator).  Like
        the reference, an existing name is OVERRIDDEN with a warning —
        users replace built-ins this way."""
        import warnings

        name = klass.__name__.lower()
        prev = OPT_REGISTRY._entries.get(name)
        if prev is not None and prev is not klass:
            warnings.warn(
                f"New optimizer {klass.__module__}.{klass.__name__} is "
                f"overriding existing optimizer {prev.__module__}."
                f"{prev.__name__}")
            OPT_REGISTRY._entries[name] = klass
        else:
            OPT_REGISTRY.register(name)(klass)
        return klass

    def set_lr_scale(self, args_lrscale):
        """Deprecated since the reference itself (optimizer.py:126-128);
        use ``set_lr_mult``."""
        raise DeprecationWarning("set_lr_scale is deprecated; use "
                                 "set_lr_mult")


create = Optimizer.create_optimizer


@register("sgd")
class SGD(Optimizer):
    """SGD with momentum / weight decay / grad clipping (optimizer.py:234)."""

    def __init__(self, momentum=0.0, **kwargs):
        self.momentum = momentum
        super().__init__(**kwargs)

    def step_param(self, w, g, m, lr, wd, t):
        g = self._preprocess(g) + wd * w
        if m is None:
            return (w - lr * g).to(w.dtype), None
        m_new = self.momentum * m - lr * g
        return (w + m_new).to(w.dtype), m_new.to(m.dtype)

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.dtype)


@register("ccsgd")
class ccSGD(SGD):
    """Alias of SGD: the reference's C++-backed fused update
    (optimizer.py:426, src/optimizer/sgd.cc) — here every optimizer is
    already a fused on-device program."""


@register("nag")
class NAG(Optimizer):
    """Nesterov accelerated gradient (optimizer.py:313)."""

    def __init__(self, momentum=0.0, **kwargs):
        self.momentum = momentum
        super().__init__(**kwargs)

    def step_param(self, w, g, m, lr, wd, t):
        g = self._preprocess(g) + wd * w
        m_new = self.momentum * m + g
        g_eff = g + self.momentum * m_new
        return (w - lr * g_eff).to(w.dtype), m_new.to(m.dtype)

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context, dtype=weight.dtype)


@register("sgld")
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (optimizer.py:361); the
    noise is drawn from a key of the framework's chain, on the weight's
    device."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = self._preprocess(grad._data) + wd * w
            key = _random.next_key(w.device)
            noise = torch.randn(w.shape, generator=key.generator(),
                                device=w.device,
                                dtype=torch.float32) * (lr ** 0.5)
            w.copy_((w - 0.5 * lr * g + noise.to(w.dtype)).to(w.dtype))


@register("adam")
class Adam(Optimizer):
    """Adam (optimizer.py:504) with the reference's bias-corrected lr.

    The bias-corrected step size is computed in float32 from the update
    count ``t``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        super().__init__(learning_rate=learning_rate, **kwargs)

    def _bias_corrected_lr(self, lr, t, like):
        tf = _f32(t, like)
        coef1 = 1.0 - torch.pow(_f32(self.beta1, like), tf)
        coef2 = 1.0 - torch.pow(_f32(self.beta2, like), tf)
        return _f32(lr, like) * torch.sqrt(coef2) / coef1

    def step_param(self, w, g, mv, lr, wd, t):
        m, v = mv
        g = self._preprocess(g) + wd * w
        m_new = self.beta1 * m + (1 - self.beta1) * g
        v_new = self.beta2 * v + (1 - self.beta2) * torch.square(g)
        lr_t = self._bias_corrected_lr(lr, t, w)
        w_new = w - lr_t * m_new / (torch.sqrt(v_new) + self.epsilon)
        return w_new.to(w.dtype), (m_new.to(m.dtype), v_new.to(v.dtype))

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),
                zeros(weight.shape, weight.context, dtype=weight.dtype))


@register("adagrad")
class AdaGrad(Optimizer):
    """AdaGrad (optimizer.py:605)."""

    def __init__(self, eps=1e-7, **kwargs):
        self.float_stable_eps = eps
        super().__init__(**kwargs)

    def step_param(self, w, g, h, lr, wd, t):
        g = self._preprocess(g)
        h_new = h + torch.square(g)
        w_new = w - lr * (g / torch.sqrt(h_new + self.float_stable_eps) + wd * w)
        return w_new.to(w.dtype), h_new.to(h.dtype)

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context, dtype=weight.dtype)


@register("rmsprop")
class RMSProp(Optimizer):
    """RMSProp, Tieleman & Hinton variant with momentum-of-gradient terms
    (optimizer.py:654: gamma1, gamma2)."""

    def __init__(self, learning_rate=0.002, gamma1=0.95, gamma2=0.9,
                 epsilon=1e-4, **kwargs):
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        super().__init__(learning_rate=learning_rate, **kwargs)

    def step_param(self, w, g, state, lr, wd, t):
        n, gavg, delta = state
        g = self._preprocess(g) + wd * w
        n_new = (1 - self.gamma1) * torch.square(g) + self.gamma1 * n
        gavg_new = (1 - self.gamma1) * g + self.gamma1 * gavg
        denom = torch.sqrt(n_new - torch.square(gavg_new) + self.epsilon)
        delta_new = self.gamma2 * delta - lr * g / denom
        return ((w + delta_new).to(w.dtype),
                (n_new.to(n.dtype), gavg_new.to(gavg.dtype),
                 delta_new.to(delta.dtype)))

    def create_state(self, index, weight):
        z = lambda: zeros(weight.shape, weight.context, dtype=weight.dtype)
        return (z(), z(), z())


@register("adadelta")
class AdaDelta(Optimizer):
    """AdaDelta (optimizer.py:730)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        self.rho, self.epsilon = rho, epsilon
        super().__init__(**kwargs)

    def step_param(self, w, g, state, lr, wd, t):
        acc_g, acc_delta = state
        g = self._preprocess(g)
        acc_g_new = self.rho * acc_g + (1 - self.rho) * torch.square(g)
        delta = (torch.sqrt(acc_delta + self.epsilon)
                 / torch.sqrt(acc_g_new + self.epsilon)) * g
        acc_delta_new = self.rho * acc_delta + (1 - self.rho) * torch.square(delta)
        w_new = w - delta - wd * w
        return w_new.to(w.dtype), (acc_g_new.to(acc_g.dtype),
                                   acc_delta_new.to(acc_delta.dtype))

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),
                zeros(weight.shape, weight.context, dtype=weight.dtype))


@register("test")
class Test(Optimizer):
    """Trivial optimizer for unit tests (optimizer.py:784)."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._data.add_(grad._data * self.rescale_grad)
            state._data.copy_(weight._data)


def _map_state(state, fn):
    """``fn`` over the NDArrays of an optimizer state (None / NDArray /
    tuple of NDArrays), keeping its structure."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_map_state(s, fn) for s in state)
    return fn(state)


def get_updater(optimizer: Optimizer):
    """Closure over per-index states (reference optimizer.py:803).

    ``updater.get_states()`` gives the bytes of a ``.states`` file: a
    pickled dict of ``states`` (index -> state, its NDArrays on the CPU),
    the optimizer's per-index update counts (``index_update_count``, from
    which Adam's bias correction is taken) and ``num_update`` (what an
    lr scheduler reads).  ``updater.set_states(blob, ctx)`` loads such
    bytes, the states on ``ctx``, so the next update continues the saved
    run."""
    states = {}

    def updater(index, grad, weight):
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        optimizer.update(index, weight, grad, states[index])

    def get_states():
        host = cpu()
        return pickle.dumps({
            "states": {i: _map_state(s, lambda a: a.as_in_context(host))
                       for i, s in states.items()},
            "index_update_count": dict(optimizer._index_update_count),
            "num_update": optimizer.num_update})

    def set_states(blob, ctx):
        saved = pickle.loads(blob)
        states.clear()
        states.update({i: _map_state(s, lambda a: a.as_in_context(ctx))
                       for i, s in saved["states"].items()})
        optimizer._index_update_count = dict(saved["index_update_count"])
        optimizer.num_update = saved["num_update"]

    updater.states = states
    updater.optimizer = optimizer
    updater.get_states = get_states
    updater.set_states = set_states
    return updater


@register("adamw")
class AdamW(Adam):
    """Adam with decoupled weight decay (Loshchilov & Hutter; beyond
    the 2016 reference — the standard transformer-training optimizer).

    ``wd`` is applied directly to the weights, scaled by the schedule
    lr, instead of being folded into the gradient."""

    def step_param(self, w, g, mv, lr, wd, t):
        m, v = mv
        g = self._preprocess(g)
        m_new = self.beta1 * m + (1 - self.beta1) * g
        v_new = self.beta2 * v + (1 - self.beta2) * torch.square(g)
        lr_t = self._bias_corrected_lr(lr, t, w)
        # decoupled decay: the weight shrinks by the schedule-lr-scaled
        # wd, independent of the moments
        w_new = (w * (1.0 - lr * wd)
                 - lr_t * m_new / (torch.sqrt(v_new) + self.epsilon))
        return w_new.to(w.dtype), (m_new.to(m.dtype), v_new.to(v.dtype))


@register("lars")
class LARS(SGD):
    """Layer-wise Adaptive Rate Scaling (You et al. 2017; beyond the
    2016 reference — the standard large-batch ResNet optimizer on TPU
    pods).  SGD+momentum whose per-layer lr is scaled by the trust
    ratio ``eta * ||w|| / (||g|| + wd * ||w||)``.  The adaptation is
    applied only to matrix/conv weights (ndim > 1); biases and norm
    scales update as plain SGD — the standard exclusion that keeps
    BatchNorm/bias updates from being crushed by their tiny norms."""

    def __init__(self, *, trust_coefficient=0.001, epsilon=1e-9, **kwargs):
        # keyword-only: LARS(0.9) must not silently set a 900x trust
        # coefficient when SGD's first positional is momentum
        self.trust_coefficient = trust_coefficient
        self.epsilon = epsilon
        super().__init__(**kwargs)

    def step_param(self, w, g, m, lr, wd, t):
        if w.dim() <= 1:
            # bias/gamma/beta: plain SGD(+momentum) step, state kept
            return SGD.step_param(self, w, g, m, lr, wd, t)
        eta, eps = self.trust_coefficient, self.epsilon
        g = self._preprocess(g)
        wf = w.float()
        gf = g.float()
        w_norm = torch.sqrt(torch.sum(torch.square(wf)))
        g_norm = torch.sqrt(torch.sum(torch.square(gf)))
        ratio = torch.where(
            (w_norm > 0) & (g_norm > 0),
            eta * w_norm / (g_norm + wd * w_norm + eps), _f32(1.0, w))
        gf = gf + wd * wf
        m_new = self.momentum * m + lr * ratio * gf
        return (wf - m_new).to(w.dtype), m_new.to(m.dtype)

    def create_state(self, index, weight):
        # momentum buffer always exists (the trust-ratio step needs it)
        return zeros(weight.shape, weight.context, dtype=weight.dtype)


@register("lamb")
class LAMB(Adam):
    """Layer-wise Adaptive Moments (You et al. 2019; beyond the 2016
    reference — the large-batch BERT/transformer optimizer).  Adam
    moments; the final update direction ``r = m̂/(sqrt(v̂)+eps) + wd*w``
    is rescaled per layer by ``||w|| / ||r||`` (matrix weights only)."""

    def __init__(self, *, epsilon=1e-6, **kwargs):
        # paper default 1e-6 — also keeps this surface numerically
        # identical to the functional lamb_opt in parallel/trainer.py.
        # Keyword-only: a positional first arg must not silently land
        # in epsilon when Adam's first positional is learning_rate.
        super().__init__(epsilon=epsilon, **kwargs)

    def step_param(self, w, g, mv, lr, wd, t):
        m, v = mv
        tf = _f32(t, w)
        coef1 = 1.0 - torch.pow(_f32(self.beta1, w), tf)
        coef2 = 1.0 - torch.pow(_f32(self.beta2, w), tf)
        g = self._preprocess(g)
        m_new = self.beta1 * m + (1 - self.beta1) * g
        v_new = self.beta2 * v + (1 - self.beta2) * torch.square(g)
        m_hat = m_new / coef1
        v_hat = v_new / coef2
        wf = w.float()
        r = m_hat / (torch.sqrt(v_hat) + self.epsilon) + wd * wf
        w_norm = torch.sqrt(torch.sum(torch.square(wf)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        ratio = torch.where((w_norm > 0) & (r_norm > 0),
                            w_norm / r_norm, _f32(1.0, w))
        if w.dim() <= 1:
            ratio = 1.0  # bias/norm params: no layer adaptation
        w_new = wf - lr * ratio * r
        return w_new.to(w.dtype), (m_new.to(m.dtype), v_new.to(v.dtype))

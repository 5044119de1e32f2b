"""The shared training-step runtime: one fused step a batch.

Counterpart of ``mxnet_tpu/perf/step_runtime.py``. Three mechanisms:

* **the fused step** (:class:`FusedStep`): forward, backward
  (``torch.autograd.grad``) and the optimizer update run as one step
  that updates parameters, optimizer state and auxiliary states in
  place. On a CUDA card the step's body runs once eagerly on a side
  stream (the warm-up: kernel builds, cuDNN's autotuner, host queries),
  is captured once in a ``torch.cuda.CUDAGraph``, and every step replays
  that graph: one launch a step in place of the JAX package's one
  donated program. On the CPU the same body runs eagerly.
* **capture guarding** (:class:`CompileGuard`): it counts captures where
  the JAX package counted traces; one is expected, and any recapture past
  it warns, or raises under ``MXTPU_RETRACE_STRICT=1``.
* **parameter-layout hoisting** (:class:`PackedRNNLayout`): the fused
  ``RNN`` op's packed parameter vector is split into per-layer and
  direction pieces once, as views of the vector, so an in-place update
  of a piece is an update of the packed parameter, and the 2-D weight
  pieces are visible to the mixed-precision cast.

A replay reads and writes the addresses it captured: the batch is copied
into static input tensors, ``lr`` and ``t`` are device scalars filled
before each replay, and the outputs live in buffers that the next step
overwrites. The optimizer rules are the functional forms of the update
ops (:func:`functional_update`); :class:`FusedOptimizerApply` applies the
same rules to a parameter set, one captured graph for the set on the
card.

Arguments of queues not ported yet raise :class:`MXNetError` naming the
queue: ``mesh``/``sharding`` (A11), ``integrity`` and
``MXTPU_INTEGRITY_PERIOD`` (A13), remat and ``MXTPU_HBM_BUDGET_MB``
(A12).
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Sequence

import torch

from .. import random as _random
from ..base import MXNetError, getenv
from ..dtypes import torch_dtype
from ..executor import build_graph_eval
from ..ndarray import NDArray
from ..ops.registry import OP_TABLE
from ..ops.rnn_ops import _GATES, _unpack, rnn_param_size
from ..ops.tensor_ops import deferred_id_checks
from ..quant import loss_scale as _ls

__all__ = ["functional_update", "has_functional_update", "CompileGuard",
           "PackedRNNLayout", "plan_param_layouts", "FusedStep",
           "ModuleStepper", "module_stepper", "FusedOptimizerApply",
           "apply_fused_triples", "fused_update_params",
           "precision_compute_dtype", "precision_loss_scale"]


# ---------------------------------------------------------------------------
# the MXTPU_PRECISION mode
# ---------------------------------------------------------------------------

def precision_compute_dtype(explicit=None):
    """A trainer's compute dtype: an explicit argument wins; otherwise
    ``MXTPU_PRECISION=bf16`` asks for the bf16 cast over fp32 master
    weights."""
    if explicit is not None:
        return explicit
    mode = str(getenv("MXTPU_PRECISION", "fp32") or "fp32").lower()
    if mode in ("bf16", "bfloat16"):
        return "bfloat16"
    if mode in ("fp32", "float32", "none", ""):
        return None
    raise MXNetError(
        f"MXTPU_PRECISION={mode!r}: expected 'fp32' or 'bf16'")


def precision_loss_scale(explicit=None):
    """The dynamic loss-scale guard: an explicit True/False/
    :class:`~mxnet_tpu_torch.quant.LossScaleConfig` wins; otherwise it
    arms exactly when ``MXTPU_PRECISION`` is bf16. Returns a
    LossScaleConfig or None."""
    if explicit is not None:
        if explicit is True:
            return _ls.LossScaleConfig()
        if explicit is False:
            return None
        return explicit
    mode = str(getenv("MXTPU_PRECISION", "fp32") or "fp32").lower()
    return _ls.LossScaleConfig() if mode in ("bf16", "bfloat16") else None


def _refuse_unported(mesh=None, sharding=None, integrity=None):
    """Raise for an argument or knob whose queue is not ported yet."""
    if mesh is not None or sharding is not None:
        raise MXNetError("a fused step over a mesh (mesh=/sharding=) needs "
                         "the ShardingPlan of queue A11, not ported yet")
    if integrity not in (None, False) or getenv(
            "MXTPU_INTEGRITY_PERIOD", 0, int) > 0:
        raise MXNetError("the integrity sentinel (integrity=, "
                         "MXTPU_INTEGRITY_PERIOD) is queue A13, not ported "
                         "yet")
    if getenv("MXTPU_HBM_BUDGET_MB", None) is not None:
        raise MXNetError("the memory budget gate (MXTPU_HBM_BUDGET_MB) is "
                         "queue A12, not ported yet")
    if getenv("MXTPU_BACKWARD_DO_MIRROR", 0, int) or getenv(
            "MXTPU_REMAT_MB", None) is not None:
        raise MXNetError("rematerialization (MXTPU_BACKWARD_DO_MIRROR, "
                         "MXTPU_REMAT_MB) is queue A12, not ported yet")


# ---------------------------------------------------------------------------
# functional optimizer rules
# ---------------------------------------------------------------------------

_FUNCTIONAL_KINDS = ("sgd", "nag", "adam", "rmsprop")


def functional_update(opt, rescale_override=None):
    """Map an Optimizer to ``(init_state, update)``:
    ``update(w, g, state, lr, wd, t) -> (new_w, new_state)`` computes
    what the registered update op computes, with ``lr`` and ``t`` (the
    update count, for Adam's bias correction) as float32 device scalars.
    ``rescale_override`` replaces the optimizer's ``rescale_grad``."""
    kind = type(opt).__name__.lower()
    rescale = float(opt.rescale_grad if rescale_override is None
                    else rescale_override)
    clip = float(opt.clip_gradient) if opt.clip_gradient else -1.0
    common = dict(rescale_grad=rescale, clip_gradient=clip)

    if kind == "sgd":
        momentum = float(getattr(opt, "momentum", 0.0))

        def init_state(w):
            return torch.zeros_like(w) if momentum else ()

        def update(w, g, s, lr, wd, t):
            if momentum:
                return OP_TABLE["sgd_mom_update"].fn(
                    w, g, s, lr=lr, momentum=momentum, wd=wd, **common)
            return OP_TABLE["sgd_update"].fn(w, g, lr=lr, wd=wd,
                                             **common), ()

        return init_state, update

    if kind == "nag":
        momentum = float(getattr(opt, "momentum", 0.0))

        def init_state(w):
            return torch.zeros_like(w) if momentum else ()

        def update(w, g, s, lr, wd, t):
            # Nesterov lookahead, as optimizer.py's NAG.update
            g = g * rescale
            if clip > 0:
                g = torch.clamp(g, -clip, clip)
            g = g + wd * w
            if momentum:
                new_s = momentum * s + g
                return w - lr * (g + momentum * new_s), new_s
            return w - lr * g, ()

        return init_state, update

    if kind == "adam":
        b1, b2, eps = float(opt.beta1), float(opt.beta2), float(opt.epsilon)

        def init_state(w):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def update(w, g, s, lr, wd, t):
            mean, var = s
            coef = torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            new_w, new_mean, new_var = OP_TABLE["adam_update"].fn(
                w, g, mean, var, lr=lr * coef, beta1=b1, beta2=b2,
                epsilon=eps, wd=wd, **common)
            return new_w, (new_mean, new_var)

        return init_state, update

    if kind == "rmsprop":
        g1, eps = float(opt.gamma1), float(opt.epsilon)

        def init_state(w):
            return torch.zeros_like(w)

        def update(w, g, s, lr, wd, t):
            return OP_TABLE["rmsprop_update"].fn(
                w, g, s, lr=lr, gamma1=g1, epsilon=eps, wd=wd, **common)

        return init_state, update

    raise MXNetError(
        f"no functional rule for optimizer {kind!r}; "
        "use sgd/nag/adam/rmsprop or the imperative update path")


def has_functional_update(opt) -> bool:
    """True when :func:`functional_update` reproduces ``opt`` exactly."""
    kind = type(opt).__name__.lower()
    if kind not in _FUNCTIONAL_KINDS:
        return False
    if kind in ("sgd", "nag") and getattr(opt, "multi_precision", False):
        return False        # fp16 master-weight tuples stay imperative
    if kind == "rmsprop" and (getattr(opt, "centered", False)
                              or getattr(opt, "clip_weights", None)):
        return False        # the rule covers the plain variant only
    return True


# ---------------------------------------------------------------------------
# capture counting
# ---------------------------------------------------------------------------

class CompileGuard:
    """Counts the programs a step builds: CUDA-graph captures on the card,
    first runs over a new set of tensors on the CPU (where the JAX
    package counted traces). Past the expected count each one is a bug
    (shape or dtype drift, rebuilt state): the guard logs a warning, or
    raises when ``MXTPU_RETRACE_STRICT=1``.

    The serving coalescer and the decode batcher count dispatch
    signatures instead (:meth:`observe`, :meth:`expect`): a new one is a
    shape the backend never ran, as it is a new XLA program in the JAX
    package."""

    def __init__(self, name: str, expected: int = 1):
        self.name = name
        self.expected = expected
        self._initial_expected = expected
        self.count = 0
        self._signatures = set()
        # observe()/expect() are called from concurrent serving worker
        # threads (re-entrant: observe holds it across _record_compile)
        self._guard_lock = threading.RLock()

    def _record_compile(self):
        """Count one program; past the budget, warn, or raise under
        ``MXTPU_RETRACE_STRICT=1``."""
        with self._guard_lock:
            self.count += 1
            over = self.count > self.expected
            n = self.count
        if over:
            what = ("dispatch signature #{}: a shape outside the warmed set"
                    if self._signatures else
                    "capture #{}: the step is being captured again")
            msg = (f"CompileGuard[{self.name}]: {what.format(n)} "
                   f"(expected {self.expected}); check input shapes/dtypes "
                   "for drift")
            if getenv("MXTPU_RETRACE_STRICT", 0, int):
                raise MXNetError(msg)
            logging.warning(msg)

    def observe(self, signature) -> bool:
        """Count a *new* dispatch signature as one program: the first
        sighting counts against the budget (and trips the strict/warn
        machinery), repeats are free. Returns True when it was new."""
        with self._guard_lock:
            if signature in self._signatures:
                return False
            self._signatures.add(signature)
            try:
                self._record_compile()
            except MXNetError:
                # the strict raise aborts the caller's dispatch: nothing
                # ran, so the signature and the count roll back and a
                # retry raises again
                self._signatures.discard(signature)
                self.count -= 1
                raise
            return True

    def expect(self, signature) -> bool:
        """Pre-register a warm-up signature: seen AND budgeted — a live
        dispatch repeating it is free, anything else counts."""
        with self._guard_lock:
            if signature in self._signatures:
                return False
            self._signatures.add(signature)
            self.count += 1
            self.expected = max(self.expected, self.count)
            return True

    def rebind(self):
        """Start a new program lifetime: the next capture is expected,
        the budget drops back to its construction-time value and the
        seen signatures are forgotten."""
        with self._guard_lock:
            self.count = 0
            self.expected = self._initial_expected
            self._signatures.clear()

    @property
    def retraced(self) -> bool:
        return self.count > self.expected


# ---------------------------------------------------------------------------
# packed-RNN parameter layout
# ---------------------------------------------------------------------------

def _flatten(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


class PackedRNNLayout:
    """Split/join rule for one fused-RNN packed parameter vector.

    ``split`` turns the flat vector into ``((w_i2h, w_h2h, b_i2h, b_h2h)
    per direction) per layer``, views of the vector that the RNN op takes
    directly. ``join`` is the inverse: free (the vector itself) when the
    pieces are still views of one vector in its layout, a concatenation
    otherwise. Momentum and Adam moments split by the same rule."""

    def __init__(self, name, state_size, num_layers, mode, bidirectional):
        self.name = name
        self.state_size = int(state_size)
        self.num_layers = int(num_layers)
        self.mode = mode
        self.bidirectional = bool(bidirectional)
        self._input_size = None

    @property
    def num_pieces(self):
        return 4 * self.num_layers * (2 if self.bidirectional else 1)

    def _resolve_input_size(self, total):
        if self._input_size is not None:
            return self._input_size
        # rnn_param_size is linear in input_size: only layer 0's i2h
        # block scales with it
        D = 2 if self.bidirectional else 1
        slope = D * _GATES[self.mode] * self.state_size
        fixed = rnn_param_size(self.num_layers, 0, self.state_size,
                               self.mode, self.bidirectional)
        cand, rem = divmod(total - fixed, slope)
        if rem or cand <= 0:
            raise MXNetError(
                f"cannot infer RNN input size from packed parameter "
                f"length {total} for {self.name!r}")
        self._input_size = int(cand)
        return self._input_size

    def split(self, flat):
        insz = self._resolve_input_size(int(flat.shape[0]))
        pieces = _unpack(flat, self.num_layers, insz, self.state_size,
                         self.mode, self.bidirectional)
        return tuple(tuple(per_dir) for per_dir in pieces)

    def join(self, pieces):
        leaves = _flatten(pieces)
        ordered = ([p for i, p in enumerate(leaves) if i % 4 < 2]
                   + [p for i, p in enumerate(leaves) if i % 4 >= 2])
        base = leaves[0]._base
        if base is not None and base.dim() == 1 and base.is_contiguous():
            offset = base.storage_offset()
            for p in ordered:
                if p._base is not base or p.storage_offset() != offset:
                    break
                offset += p.numel()
            else:
                if offset - base.storage_offset() == base.numel():
                    return base
        return torch.cat([p.reshape(-1) for p in ordered])


def plan_param_layouts(symbol) -> Dict[str, PackedRNNLayout]:
    """Packed parameters that can be hoisted to piece layout: a variable
    whose only consumer is the ``parameters`` slot of a fused ``RNN``
    node."""
    nodes = symbol._topo_nodes()
    consumers: Dict[int, int] = {}
    for n in nodes:
        if n.is_variable:
            continue
        for p, _ in n.inputs:
            if p.is_variable:
                consumers[id(p)] = consumers.get(id(p), 0) + 1
    layouts: Dict[str, PackedRNNLayout] = {}
    for node in nodes:
        if node.is_variable or node.op.name != "RNN":
            continue
        if len(node.inputs) < 2:
            continue
        pvar = node.inputs[1][0]
        if not pvar.is_variable or consumers.get(id(pvar), 0) != 1:
            continue
        layouts[pvar.name] = PackedRNNLayout(
            pvar.name, node.attrs["state_size"], node.attrs["num_layers"],
            node.attrs.get("mode", "lstm"),
            node.attrs.get("bidirectional") in (True, "True", "1"))
    return layouts


# ---------------------------------------------------------------------------
# state-format adapters (functional <-> the imperative Updater)
# ---------------------------------------------------------------------------

def _to_tensor(v):
    return v._data if isinstance(v, NDArray) else torch.as_tensor(v)


def _is_empty(state):
    return isinstance(state, tuple) and not state


def _imp_state_to_functional(kind, state):
    """Imperative ``create_state`` output -> functional-rule state: the
    updater's own tensors, not copies."""
    if kind in ("sgd", "nag"):
        if isinstance(state, tuple):        # multi-precision master weights
            raise MXNetError("multi-precision state is not fusable")
        return () if state is None else _to_tensor(state)
    if kind == "adam":
        mean, var = state
        return (_to_tensor(mean), _to_tensor(var))
    if kind == "rmsprop":
        (n,) = state
        return _to_tensor(n)
    raise MXNetError(f"no state adapter for optimizer {kind!r}")


def _point(arr, tensor):
    """Put ``tensor`` behind the NDArray ``arr`` unless it is there."""
    if arr._data is not tensor:
        arr._set_data(tensor)


def _functional_state_to_imp(kind, fstate, existing):
    """Put a functional state behind the imperative containers (the
    NDArrays the Updater owns), so that aliases observe it; returns
    ``existing``."""
    if kind in ("sgd", "nag"):
        if existing is not None and not _is_empty(fstate):
            _point(existing, fstate)
        return existing
    if kind == "adam":
        _point(existing[0], fstate[0])
        _point(existing[1], fstate[1])
        return existing
    if kind == "rmsprop":
        _point(existing[0], fstate)
        return existing
    raise MXNetError(f"no state adapter for optimizer {kind!r}")


def _tree_map2(fn, a, b):
    if isinstance(a, tuple):
        return tuple(_tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _copy_into(dst, src):
    """Copy the leaves of ``src`` into those of ``dst`` in place (a leaf
    that is the same tensor is left alone)."""
    def copy(d, s):
        if d is not s:
            d.copy_(s)
        return d
    _tree_map2(copy, dst, src)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for k in tree for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in _tensors(item)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# ---------------------------------------------------------------------------
# FusedStep: forward, backward and update as one captured step
# ---------------------------------------------------------------------------

class FusedStep:
    """One symbol, one optimizer, one training step updated in place.

    ``step(params, states, aux, inputs, rng, lr, t)`` returns ``(params,
    states, aux, outputs)``: the same containers, their tensors updated
    in place. ``params`` maps each trainable name to its tensor (packed
    RNN vectors included: the step splits them into views); ``states``
    each name to a list of functional states, one a leaf (one a piece
    for a packed vector); ``inputs`` the batch and any frozen parameters;
    ``lr`` and ``t`` are float32 device scalars; ``rng`` is unused (the
    ops draw from ``random.generator`` of the device).

    The update is always in place, where the JAX package donates its
    step's buffers.

    ``compute_dtype`` casts every float32 leaf of two or more dimensions
    to that dtype inside the step, the embedding table before its gather;
    the master parameters stay float32. With a loss scale
    (``loss_scale``, ``MXTPU_PRECISION=bf16``), a step whose gradients
    are not all finite changes nothing and backs the scale off; a step
    whose batch holds a token id outside an Embedding's table changes
    nothing either, and the next call (or :meth:`check_ids`) raises.

    On a CUDA card the first call runs the body on a side stream and
    captures it in a CUDA graph; every call replays it, so every call
    must pass the same tensors (refill them in place). A call over other
    tensors captures again, which :attr:`guard` counts."""

    def __init__(self, symbol, optimizer, param_names: Sequence[str],
                 compute_dtype=None, name: str = "fused-step", mesh=None, sharding=None,
                 loss_scale=None, integrity=None):
        _refuse_unported(mesh, sharding, integrity)
        self._symbol = symbol
        self._optimizer = optimizer
        self._param_names = list(param_names)
        compute_dtype = precision_compute_dtype(compute_dtype)
        self._ls_cfg = precision_loss_scale(loss_scale)
        self._ls_state = None
        self._eval_fn = build_graph_eval(symbol)
        nodes = [n for n in symbol._topo_nodes() if not n.is_variable]
        self.needs_rng = any(n.op.needs_rng and n.op.uses_rng(n.attrs)
                             for n in nodes)
        self._checks_ids = any(n.op.name == "Embedding" for n in nodes)
        self._ids_bad = None        # the last step's flag, on the device
        self._ids_unread = False    # a step ran since the flag was read
        self.layouts = {n: lo for n, lo in plan_param_layouts(symbol).items()
                        if n in self._param_names}
        self.guard = CompileGuard(name)
        self._kind = type(optimizer).__name__.lower()
        self._init_state, self._update = functional_update(optimizer)
        self._wd = {n: float(optimizer.wd * optimizer.wd_mult.get(n, 1.0))
                    for n in self._param_names}
        self._lr_mult = {n: float(optimizer.lr_mult.get(n, 1.0))
                         for n in self._param_names}
        self.compute_dtype = (torch_dtype(compute_dtype) if compute_dtype
                              else None)
        self._key = None        # the tensors the step was built over
        self._graph = None      # the captured CUDA graph
        self._outs = None       # the output buffers steps write

    def _cast(self, v):
        cdt = self.compute_dtype
        if cdt is not None and v.dim() >= 2 and v.dtype == torch.float32:
            return v.to(cdt)
        return v

    # -- state ---------------------------------------------------------------

    def init(self, arg_params: Dict, aux_params: Dict,
             imp_states: Optional[Dict[int, object]] = None):
        """(params, states, aux) from name -> NDArray or tensor dicts. The
        tensors are taken as they are (contiguous ones are not copied).
        ``imp_states`` maps a parameter's index in ``param_names`` to its
        imperative ``create_state`` value, whose tensors the functional
        state shares; missing ones start at the optimizer's zero state."""
        def own(v):
            t = _to_tensor(v)
            return t if t.is_contiguous() else t.contiguous()

        params, states = {}, {}
        for i, n in enumerate(self._param_names):
            v = own(arg_params[n])
            imp = (imp_states or {}).get(i)
            fs = (self._init_state(v) if imp is None
                  else _imp_state_to_functional(self._kind, imp))
            params[n] = v
            states[n] = (self._split_state(n, fs) if n in self.layouts
                         else [fs])
        aux = {n: own(v) for n, v in aux_params.items()}
        return params, states, aux

    def _split_state(self, name, fstate):
        """A packed-shaped functional state -> one state a piece (views)."""
        lo = self.layouts[name]
        if _is_empty(fstate):
            return [() for _ in range(lo.num_pieces)]
        if isinstance(fstate, tuple):       # adam (mean, var)
            parts = [_flatten(lo.split(f)) for f in fstate]
            return [tuple(p[i] for p in parts) for i in range(len(parts[0]))]
        return _flatten(lo.split(fstate))

    def _join_state(self, name, leaves):
        lo = self.layouts[name]
        if not leaves or _is_empty(leaves[0]):
            return ()
        if isinstance(leaves[0], tuple):    # adam (mean, var) a piece
            return tuple(lo.join([l[j] for l in leaves])
                         for j in range(len(leaves[0])))
        return lo.join(leaves)

    def packed_state(self, name, state_leaves):
        """Functional state leaves -> one imperative-shaped state value."""
        if name in self.layouts:
            return self._join_state(name, state_leaves)
        return state_leaves[0]

    def loss_scale_stats(self):
        """Host snapshot of the guard state (None when unarmed): a
        boundary read, never on the step path."""
        if self._ls_cfg is None:
            return None
        if self._ls_state is None:
            return {"scale": self._ls_cfg.init_scale, "finite_streak": 0}
        scale, streak = self._ls_state
        return {"scale": float(scale), "finite_streak": int(streak)}

    def check_ids(self):
        """Raise if the last step saw a token id outside an Embedding's
        table (that step changed nothing). Reads one bool back, once a
        step."""
        if not self._ids_unread:
            return
        self._ids_unread = False
        if bool(self._ids_bad):
            raise MXNetError("Embedding: a token id outside the table's "
                             "range reached a fused step; that step "
                             "changed nothing")

    def rebind(self):
        """Drop the captured graph: the next call builds (and the guard
        expects) a new one."""
        self.guard.rebind()
        self.release()
        return self

    def release(self):
        """Free the captured graph and its memory pool."""
        self._graph = self._outs = self._key = None

    # -- the step ------------------------------------------------------------

    def _body(self, params, states, aux, inputs, lr, t):
        """Forward, backward and the in-place update; returns the outputs
        (detached)."""
        device = lr.device
        merged = dict(inputs)
        leaves = {}
        for n in self._param_names:
            if n in self.layouts:
                pieces = self.layouts[n].split(params[n].detach())
                leaves[n] = [p.requires_grad_() for p in _flatten(pieces)]
                merged[n] = tuple(
                    tuple(tuple(self._cast(p) for p in per_dir)
                          for per_dir in per_layer) for per_layer in pieces)
            else:
                leaf = params[n].detach().requires_grad_()
                leaves[n] = [leaf]
                merged[n] = self._cast(leaf)
        flags = []
        with torch.enable_grad():
            with deferred_id_checks(flags if self._checks_ids else None):
                outs, aux_up = self._eval_fn(merged, aux, device, True)
            # terminal loss layers define their own gradient and ignore
            # the head cotangent: ones, as the executor's backward
            heads = [o for o in outs if o.requires_grad]
            flat = [leaf for n in self._param_names for leaf in leaves[n]]
            grads = (torch.autograd.grad(
                heads, flat, [torch.ones_like(o) for o in heads],
                allow_unused=True) if heads else [None] * len(flat))
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(flat, grads)]
        with torch.no_grad():
            ok = finite = None
            if self._ls_cfg is not None:
                finite = _ls.tree_all_finite(grads).to(device)
                ok = finite
            if flags:
                bad = torch.stack(flags).any()
                self._ids_bad.copy_(bad)
                ok = ~bad if ok is None else ok & ~bad
            i = 0
            for n in self._param_names:
                lr_n = lr if self._lr_mult[n] == 1.0 else lr * self._lr_mult[n]
                for leaf, s in zip(leaves[n], states[n]):
                    w = leaf.detach()
                    w2, s2 = self._update(w, grads[i], s, lr_n, self._wd[n], t)
                    i += 1
                    if ok is not None:
                        w2 = _ls.guarded_select(ok, w2, w)
                        s2 = _tree_map2(
                            lambda new, old: _ls.guarded_select(ok, new, old),
                            s2, s)
                    w.copy_(w2)
                    _copy_into(s, s2)
            for n, v in aux_up.items():
                new = v.detach()
                if ok is not None:
                    new = _ls.guarded_select(ok, new, aux[n])
                aux[n].copy_(new)
            if finite is not None:
                _copy_into(self._ls_state,
                           _ls.next_state(self._ls_state, finite,
                                          self._ls_cfg))
        return [o.detach() for o in outs]

    def __call__(self, params, states, aux, inputs, rng, lr, t, *,
                 capture=True):
        """One step. On a CUDA card a call over the tensors of the last
        replays its graph, a call over others runs the body on a side
        stream and captures it; ``capture=False`` runs the body eagerly
        on the card instead (for checks and timing)."""
        device = lr.device
        if self._ls_cfg is not None and self._ls_state is None:
            self._ls_state = _ls.init_state(self._ls_cfg, device)
        if self._checks_ids:
            if self._ids_bad is None:
                self._ids_bad = torch.zeros((), dtype=torch.bool,
                                            device=device)
            self.check_ids()
            self._ids_unread = True
        args = (params, states, aux, inputs, lr, t)
        key = tuple((id(x), x.data_ptr(), tuple(x.shape), x.dtype)
                    for x in _tensors(list(args)))
        if not capture and device.type == "cuda":
            key = ("eager",) + key
            if self._graph is not None:
                self.release()
        if key == self._key:
            if self._graph is not None:
                self._graph.replay()
            else:
                for buf, o in zip(self._outs, self._body(*args)):
                    buf.copy_(o)
            return params, states, aux, self._outs
        self.release()
        self.guard._record_compile()
        if device.type != "cuda" or not capture:
            self._outs = [o.clone() for o in self._body(*args)]
        else:
            self._outs = self._capture(args, device)
        self._key = key
        return params, states, aux, self._outs

    def _capture(self, args, device):
        """Run the body once on a side stream (this call's step), capture
        it in a CUDA graph (recorded, not run), and give the warm-up's
        outputs the graph's output buffers."""
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = self._body(*args)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.needs_rng:
            graph.register_generator_state(_random.generator(device))
        with torch.cuda.graph(graph):
            outs = self._body(*args)
        for buf, o in zip(outs, warm):
            buf.copy_(o)
        self._graph = graph
        return outs


# ---------------------------------------------------------------------------
# Module front end
# ---------------------------------------------------------------------------

class ModuleStepper:
    """Drives a bound Module through :class:`FusedStep`.

    The step updates the executor's parameters and auxiliary states and
    the updater's optimizer state in place: the module's NDArrays hold the
    tensors the step captured. ``sync_to_module`` brings the update counts
    and any missing updater state up to date, so that ``get_params``,
    checkpoints and ``save_optimizer_states`` see what a forward_backward
    and update loop would have produced. After a write into the module
    from outside (``invalidate``), the next step copies the module's
    values into its tensors (``refresh``) without capturing again."""

    def __init__(self, module, fused: FusedStep, frozen: Sequence[str]):
        self._module = module
        self._fused = fused
        self._frozen = list(frozen)
        exec_ = module._exec
        device = exec_._device
        # updater states are keyed by position in the module's param list;
        # remap to the fused (trainable) positions
        self._mod_index = {n: i for i, n in enumerate(module._param_names)}
        self._lr = torch.zeros((), dtype=torch.float32, device=device)
        self._t = torch.zeros((), dtype=torch.float32, device=device)
        names = [n for n in module._data_names + module._label_names
                 if n in exec_.arg_dict]
        self._inputs = {n: torch.empty_like(exec_.arg_dict[n]._data)
                        for n in names}
        self._params, self._states, self._aux = self._pull()
        for n in self._frozen:
            self._inputs[n] = _contiguous(exec_.arg_dict[n]._data)
        self._adopt()
        self._num_update = module._optimizer.num_update
        self._outputs = None
        self._synced = True
        self._stale = False

    @property
    def guard(self):
        return self._fused.guard

    def _imp_states(self):
        updater = self._module._updater
        if updater is None or not updater.states:
            return None
        return {i: updater.states[self._mod_index[n]]
                for i, n in enumerate(self._fused._param_names)
                if self._mod_index[n] in updater.states}

    def _pull(self):
        exec_ = self._module._exec
        return self._fused.init(
            {n: exec_.arg_dict[n] for n in self._fused._param_names},
            {n: exec_.aux_dict[n] for n in exec_._aux_names},
            imp_states=self._imp_states())

    def _adopt(self):
        """Put the step's tensors behind the module's NDArrays."""
        mod = self._module
        exec_ = mod._exec
        for n, v in self._params.items():
            _point(exec_.arg_dict[n], v)
        for n in self._frozen:
            _point(exec_.arg_dict[n], self._inputs[n])
        for n, v in self._aux.items():
            _point(exec_.aux_dict[n], v)
        updater = mod._updater
        if updater is None:
            return
        for n in self._fused._param_names:
            state = updater.states.get(self._mod_index[n])
            if state is not None:
                _functional_state_to_imp(
                    self._fused._kind,
                    self._fused.packed_state(n, self._states[n]), state)

    def invalidate(self):
        """The module's parameters or optimizer state were written from
        outside; the next step copies them in first. The captured graph
        stays."""
        self._stale = True

    def rebind(self):
        """Drop the captured graph; the next step captures afresh."""
        self._fused.rebind()
        return self

    def release(self):
        """Free the captured graph and its memory pool (the module keeps
        the trained values)."""
        self._fused.release()
        self._outputs = None

    def refresh(self):
        exec_ = self._module._exec
        params, states, aux = self._pull()
        for n, v in params.items():
            _copy_into(self._params[n], v)
        for n, leaves in states.items():
            for dst, src in zip(self._states[n], leaves):
                _copy_into(dst, src)
        for n, v in aux.items():
            _copy_into(self._aux[n], v)
        for n in self._frozen:
            _copy_into(self._inputs[n], exec_.arg_dict[n]._data)
        self._adopt()
        self._num_update = self._module._optimizer.num_update
        self._synced = True
        self._stale = False

    def step(self, data_batch, capture=True):
        """One fused step on ``data_batch``; ``capture=False`` runs the
        step's body eagerly on the card (see :class:`FusedStep`)."""
        self._fused.check_ids()
        if self._stale:
            self.refresh()
        mod = self._module
        for name, val in mod._input_dict(data_batch).items():
            dst = self._inputs.get(name)
            if dst is None:
                continue
            src = _to_tensor(val)
            if tuple(src.shape) != tuple(dst.shape):
                raise MXNetError(f"fused step: {name} of shape "
                                 f"{tuple(src.shape)}, bound as "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        self._num_update += 1
        opt = mod._optimizer
        self._lr.fill_(opt.lr if opt.lr_scheduler is None
                       else opt.lr_scheduler(self._num_update))
        self._t.fill_(float(self._num_update))
        _, _, _, outs = self._fused(self._params, self._states, self._aux,
                                    self._inputs, None, self._lr, self._t,
                                    capture=capture)
        if self._outputs is None or self._outputs[0]._data is not outs[0]:
            self._outputs = [NDArray(o) for o in outs]
        mod._exec.outputs = self._outputs
        mod._params_dirty = True
        self._synced = False
        return outs

    def sync_to_module(self):
        """Bring the module's update counts and updater states up to date
        (the parameters are already in place)."""
        if self._synced:
            return
        self._fused.check_ids()
        mod = self._module
        exec_ = mod._exec
        opt = mod._optimizer
        updater = mod._updater
        for n in self._fused._param_names:
            mi = self._mod_index[n]
            opt._index_update_count[mi] = self._num_update
            if updater is not None and mi not in updater.states:
                updater.states[mi] = opt.create_state(mi, exec_.arg_dict[n])
                updater.states_synced[mi] = True
        self._adopt()
        opt.num_update = max(opt.num_update, self._num_update)
        self._synced = True


def _contiguous(t):
    return t if t.is_contiguous() else t.contiguous()


def module_stepper(module, compute_dtype=None, mesh=None, sharding=None,
                   loss_scale=None, integrity=None):
    """A :class:`ModuleStepper` for ``module``, or None.

    Eligibility is the JAX package's: a kvstore-free local update, dense
    gradients, ``grad_req='write'`` (or ``'null'``: frozen), no module
    states, no input gradients, and an optimizer with a functional rule.
    ``MXTPU_FUSED_STEP=0`` turns the fused path off. ``mesh``,
    ``sharding`` and ``integrity`` raise until their queues (A11, A13)
    are ported."""
    if not getenv("MXTPU_FUSED_STEP", 1, int):
        return None
    _refuse_unported(mesh, sharding, integrity)
    if not (module.binded and module.params_initialized
            and module.optimizer_initialized):
        return None
    if module._kvstore is not None or getattr(module, "_update_on_kvstore",
                                              False):
        return None
    if module._state_names or module.inputs_need_grad:
        return None
    if not has_functional_update(module._optimizer):
        return None
    exec_ = module._exec
    frozen = []
    for n in module._param_names:
        req = exec_._grad_req.get(n, "null")
        if req == "write":
            continue
        if req == "null":
            frozen.append(n)
        else:
            return None     # grad_req='add' accumulation stays imperative
    trainable = [n for n in module._param_names if n not in frozen]
    if not trainable:
        return None
    try:
        fused = FusedStep(module._symbol, module._optimizer, trainable,
                          compute_dtype=compute_dtype,
                          name=f"module-step:{type(module).__name__}",
                          loss_scale=loss_scale)
        stepper = ModuleStepper(module, fused, frozen)
    except MXNetError:
        return None
    if hasattr(module, "_fused_stepper"):
        module._fused_stepper = stepper
    return stepper


# ---------------------------------------------------------------------------
# fused optimizer apply (model._update_params)
# ---------------------------------------------------------------------------

class FusedOptimizerApply:
    """Apply one optimizer to N parameters as one step: each parameter's
    :func:`functional_update` rule, the fused step's, in place. On a CUDA
    card the first call over a parameter set runs the loop on a side
    stream and captures it in a CUDA graph; later calls replay it, one
    launch for the whole set where the per-parameter updater makes
    several a parameter. The gradients are copied into the graph's own
    buffers (the executor makes new ones every backward), and ``lr``,
    ``wd``, ``t`` and ``rescale`` reach it as one device array. The guard
    counts one capture a parameter-set signature; a changed signature
    raises its budget (a legitimate new set, not thrash).
    ``loss_scale`` (a :class:`~mxnet_tpu_torch.quant.LossScaleConfig`, or
    True for the default one; the Gluon Trainer's) arms the guard inside
    the step: when any rescaled gradient is not finite every weight and
    state keeps its value, and ``last_finite`` (read back once, after the
    step) says whether the step applied.
    ``mesh``/``sharding`` (ZeRO, queue A11) raise."""

    def __init__(self, optimizer, name="fused-update", mesh=None,
                 sharding=None, loss_scale=None):
        _refuse_unported(mesh, sharding)
        if loss_scale is True:
            loss_scale = _ls.LossScaleConfig()
        self._ls_cfg = loss_scale or None
        self.last_finite = True
        self._opt = optimizer
        self._kind = type(optimizer).__name__.lower()
        if not has_functional_update(optimizer):
            raise MXNetError(
                f"optimizer {self._kind!r} has no functional rule")
        # rescale=1.0: the loop rescales the gradient first
        _, self._update = functional_update(optimizer, rescale_override=1.0)
        self.guard = CompileGuard(name)
        self._sig = None
        self._graph = None
        self._bufs = None   # (ws, gs, ss, hyper) the graph reads and writes
        self._finite = None  # the guard's device flag, written by the step

    def state_to_functional(self, state):
        return _imp_state_to_functional(self._kind, state)

    def writeback_state(self, fstate, existing):
        return _functional_state_to_imp(self._kind, fstate, existing)

    def _body(self, ws, gs, ss, hyper):
        """Each parameter's rule, in place; ``hyper[:, i]`` holds the i-th
        parameter's lr, wd, t and rescale. The gradient is rescaled in
        fp32 and rounded to its own dtype, as the update op multiplies it
        by a Python float. Under the loss-scale guard a step with any
        non-finite rescaled gradient selects every old value
        (``guarded_select``) and writes the flag into ``self._finite``."""
        def scaled(i, g):
            return (g.float() * hyper[3, i]).to(g.dtype)

        finite = None
        if self._ls_cfg is not None:
            finite = _ls.tree_all_finite(
                [scaled(i, g) for i, g in enumerate(gs)]).to(hyper.device)
            self._finite.copy_(finite)
        for i, (w, g, s) in enumerate(zip(ws, gs, ss)):
            lr, wd, t, _ = hyper[:, i]
            w2, s2 = self._update(w, scaled(i, g), s, lr, wd, t)
            if finite is not None:
                w2 = _ls.guarded_select(finite, w2, w)
                s2 = _tree_map2(lambda new, old: _ls.guarded_select(
                    finite, new, old), s2, s)
            w.copy_(w2)
            _copy_into(s, s2)

    def _capture(self, ws, gs, ss, hyper):
        """Run the loop on a side stream (this call's update), then capture
        it (recorded, not run) over the graph's own gradient buffers."""
        device = hyper.device
        bufs = (ws, [torch.empty_like(g) for g in gs], ss, hyper)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._body(ws, gs, ss, hyper)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body(*bufs)
        self._graph, self._bufs = graph, bufs

    def __call__(self, ws, gs, ss, lrs, wds, ts, rescale):
        """Update the weights ``ws`` and functional states ``ss`` in place
        from the gradients ``gs``; returns ``(ws, ss)``. A weight or state
        that is not the tensor the graph was captured over is copied in
        before the replay and back out after it."""
        ws, gs, ss = list(ws), list(gs), list(ss)
        device = ws[0].device
        hyper = torch.tensor([lrs, wds, ts, [float(rescale)] * len(ws)],
                             dtype=torch.float32)
        if self._ls_cfg is not None and (self._finite is None
                                         or self._finite.device != device):
            self._finite = torch.ones((), dtype=torch.bool, device=device)
        sig = tuple((tuple(x.shape), x.dtype)
                    for x in _tensors([ws, gs, ss]))
        if sig != self._sig:
            if self._sig is not None:
                self.guard.expected += 1
            self.guard._record_compile()
            self._sig, self._graph, self._bufs = sig, None, None
            if device.type == "cuda":
                self._capture(ws, gs, ss, hyper.to(device))
                return ws, ss
        if self._graph is None:
            self._body(ws, gs, ss, hyper.to(device))
            return ws, ss
        cws, cgs, css, chyper = self._bufs
        moved = [(mine, theirs) for mine, theirs in zip(
            _tensors([cws, css]), _tensors([ws, ss])) if mine is not theirs]
        for mine, theirs in moved:
            mine.copy_(theirs)
        torch._foreach_copy_(cgs, gs)
        # from pinned memory: a copy from pageable memory would make the
        # host wait for the step's backward to finish
        chyper.copy_(hyper.pin_memory(), non_blocking=True)
        self._graph.replay()
        for mine, theirs in moved:
            theirs.copy_(mine)
        return ws, ss


def apply_fused_triples(apply, opt, triples, get_state):
    """Convert, count, apply and write back (the ``_update_params`` fused
    path). ``triples``: ``(index, weight_nd, grad_nd)``;
    ``get_state(index)`` gives the imperative state. Every state is
    converted before any count moves, so a conversion failure returns
    False with the counts untouched; True when applied."""
    try:
        fss = [apply.state_to_functional(get_state(i))
               for i, _w, _g in triples]
    except (MXNetError, TypeError, ValueError):
        return False
    ws, gs, ss, lrs, wds, ts = [], [], [], [], [], []
    for (i, w, g), fs in zip(triples, fss):
        opt._update_count(i)
        lrs.append(opt._get_lr(i))
        wds.append(opt._get_wd(i))
        ts.append(opt._index_update_count[i])
        ws.append(w._data)
        gs.append(g._data)
        ss.append(fs)
    new_ws, new_ss = apply(ws, gs, ss, lrs, wds, ts, opt.rescale_grad)
    if getattr(apply, "_ls_cfg", None) is not None:
        # one value read back after the step: the host-side loss-scale
        # schedule needs the flag before the next loss is scaled
        apply.last_finite = bool(apply._finite)
    for (i, w, _g), nw, ns in zip(triples, new_ws, new_ss):
        w._set_data(nw)
        state = get_state(i)
        if state is not None:
            apply.writeback_state(ns, state)
    return True


def fused_update_params(param_arrays, grad_arrays, updater, param_names):
    """The fused path of ``model._update_params`` (local, kvstore-free):
    True when the whole update was applied at once; False means the
    caller runs the per-parameter loop. Updater-state bookkeeping
    (creation, update counts) matches the per-parameter path, so
    optimizer-state checkpoints are the same."""
    if not getenv("MXTPU_FUSED_STEP", 1, int):
        return False
    opt = updater.optimizer
    if not has_functional_update(opt):
        return False
    live = []
    for index, (w, g) in enumerate(zip(param_arrays, grad_arrays)):
        if g is None or (isinstance(g, list) and g[0] is None):
            continue
        if isinstance(w, list) or isinstance(g, list):
            return False
        if not (isinstance(w, NDArray) and isinstance(g, NDArray)):
            return False
        live.append((index, w, g))
    if not live:
        return True
    apply = getattr(updater, "_fused_apply", None)
    if apply is None or apply._opt is not opt:
        apply = FusedOptimizerApply(opt, name="updater-apply")
        updater._fused_apply = apply
    for index, w, _g in live:
        if index not in updater.states:
            updater.states[index] = opt.create_state(index, w)
            updater.states_synced[index] = True
    return apply_fused_triples(apply, opt, live,
                               lambda i: updater.states[i])

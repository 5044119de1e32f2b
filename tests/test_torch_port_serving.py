"""Parity of the PyTorch port's serving runtime with the JAX package.

The same scenarios drive ``mxnet_tpu.serving`` and ``mxnet_tpu_torch.
serving`` over the same numpy backend functions, in the deterministic
``workers=0`` mode on an injected clock (no real sleeps): admission and
shedding, priorities, deadlines, tenant quotas and stride shares, the
circuit breaker under ``FaultPlan``, coalescing into warmed buckets,
``UnwarmedSignature`` under ``MXTPU_RETRACE_STRICT=1``, pad-waste
accounting (dense and packed), the probes and the signal drain. Every
answer must match bit for bit, every error by type, and every
``stats()`` dict key for key and value for value. The two exceptions are
``warmup_cache_hits`` and ``warmup_compiles``: the JAX package counts its
executable cache's hits and XLA compiles there, the port its kernel
libraries found built and built (``mxnet_tpu_torch.compiler``); their
keys must still agree.

It also pins the executor repair the server needs: a module bound at 4
rows answers 1, 2, 3 and 4 rows with outputs of those rows, as the JAX
package's does.
"""
import signal
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt

# the counters whose meaning differs between the packages (module doc)
COMPILE_KEYS = ("warmup_cache_hits", "warmup_compiles")
# fp32 FullyConnected, one product of 3 terms: summation order only
EXEC_TOL = 1e-6


class FakeClock:
    """A manually driven monotonic clock."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _jax_pkg():
    import mxnet_tpu
    from mxnet_tpu import resilience, serving
    from mxnet_tpu.resilience import faults, supervisor
    from mxnet_tpu.resilience.retry import set_default_policy
    return types.SimpleNamespace(mx=mxnet_tpu, serving=serving,
                                 resilience=resilience, faults=faults,
                                 supervisor=supervisor,
                                 set_default_policy=set_default_policy)


def _port_pkg():
    from mxnet_tpu_torch import resilience, serving
    from mxnet_tpu_torch.resilience import faults, supervisor
    from mxnet_tpu_torch.resilience.retry import set_default_policy
    return types.SimpleNamespace(mx=mxt, serving=serving,
                                 resilience=resilience, faults=faults,
                                 supervisor=supervisor,
                                 set_default_policy=set_default_policy)


def _canon(value):
    """A comparable form: arrays by dtype, shape and bytes."""
    if isinstance(value, np.ndarray):
        return ("nd", str(value.dtype), value.shape, value.tobytes())
    if isinstance(value, dict):
        return {k: _canon(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_canon(v) for v in value]
    return value


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + str(k))
        if isinstance(v, dict):
            out |= _keys(v, prefix + str(k) + ".")
    return out


class Trace:
    """What one package did: results, error types and stats, in order."""

    def __init__(self):
        self.events = []

    def call(self, label, fn):
        try:
            value = fn()
        except Exception as err:  # noqa: BLE001 — the type is the result
            self.events.append((label, "err", type(err).__name__))
            return None
        self.events.append((label, "ok", _canon(value)))
        return value

    def note(self, label, value):
        self.events.append((label, "note", _canon(value)))

    def stats(self, label, srv):
        st = srv.stats()
        self.events.append((label, "keys", sorted(_keys(st))))
        self.events.append((label, "stats", _canon(
            {k: v for k, v in st.items() if k not in COMPILE_KEYS})))


def _rows(n, dim=3, fill=1.0):
    return np.full((n, dim), fill, np.float32)


def _echo(arrays):
    return [np.ascontiguousarray(arrays["data"], np.float32) * 2.0]


def _tracking(seen, record=lambda a: a["data"].shape):
    def fn(arrays):
        seen.append(record(arrays))
        return _echo(arrays)
    return fn


def _server(P, clock, *, fn=_echo, row=None, **kw):
    kw.setdefault("workers", 0)
    kw.setdefault("clock", clock)
    backend = P.serving.CallableBackend(
        fn, input_specs=None if row is None else {"data": row})
    srv = P.serving.InferenceServer(backend, **kw)
    srv.warm_up()
    return srv


# ---------------------------------------------------------------------------
# scenarios: each runs unchanged against either package
# ---------------------------------------------------------------------------

def sc_admission(P, t, clock):
    srv = _server(P, clock, capacity=2, name="adm-reject")
    r1 = srv.submit(_rows(1, fill=1.0))
    r2 = srv.submit(_rows(1, fill=2.0))
    t.call("over capacity", lambda: srv.submit(_rows(1)))
    srv.run_pending()
    t.call("r1", lambda: srv.result(r1))
    t.call("r2", lambda: srv.result(r2))
    t.stats("reject", srv)
    srv.close()

    srv = _server(P, clock, capacity=2, shed_policy="evict-oldest",
                  name="adm-evict")
    r1 = srv.submit(_rows(1, fill=1.0))
    r2 = srv.submit(_rows(1, fill=2.0))
    r3 = srv.submit(_rows(1, fill=3.0))          # evicts r1
    t.call("evicted", lambda: srv.result(r1))
    srv.run_pending()
    t.call("r2", lambda: srv.result(r2))
    t.call("r3", lambda: srv.result(r3))
    t.stats("evict", srv)
    srv.close()

    seen = []
    srv = _server(P, clock, fn=_tracking(seen, lambda a: float(
        a["data"][0, 0])), capacity=8, shed_policy="evict-oldest",
        name="adm-prio")
    for i in range(3):
        srv.submit(_rows(1, fill=float(i)), priority=0)
    srv.submit(_rows(1, fill=9.0), priority=5)
    srv.submit(_rows(1, fill=7.0), priority=1)
    srv.run_pending()
    t.note("priority order", seen)
    t.stats("priority", srv)
    srv.close()


def sc_deadlines(P, t, clock):
    calls = []
    srv = _server(P, clock, fn=_tracking(calls), name="dl",
                  wait=lambda event, timeout: event.is_set())
    req = srv.submit(_rows(1), deadline=1.0)
    clock.advance(2.0)                        # expires in the queue
    srv.run_pending()
    t.call("expired in queue", lambda: srv.result(req))
    req = srv.submit(_rows(1), deadline=1.0)
    clock.advance(2.0)                        # the caller gives up first
    t.call("expired at result", lambda: srv.result(req))
    srv.run_pending()
    req = srv.submit(_rows(1, fill=4.0), deadline=5.0)
    srv.run_pending()
    t.call("in time", lambda: srv.result(req))
    t.note("backend calls", calls)
    t.stats("deadlines", srv)
    srv.close()


def sc_tenants(P, t, clock):
    srv = _server(P, clock, tenants="acme:2", capacity=16, name="quota")
    held = [srv.submit(_rows(1), tenant="acme") for _ in range(2)]
    t.call("over quota", lambda: srv.submit(_rows(1), tenant="acme"))
    other = srv.submit(_rows(1, fill=3.0), tenant="other")
    srv.run_pending()
    for i, req in enumerate(held + [other]):
        t.call(f"r{i}", lambda req=req: srv.result(req))
    t.call("quota freed", lambda: srv.predict(_rows(1), tenant="acme"))
    t.stats("quota", srv)
    srv.close()

    seen = []
    srv = _server(P, clock, fn=_tracking(seen, lambda a: float(
        a["data"][0, 0])), tenants="A:*:2,B:*:1", capacity=32,
        name="stride")
    for i in range(6):
        srv.submit(_rows(1, fill=float(i)), tenant="A")
        srv.submit(_rows(1, fill=100.0 + i), tenant="B")
    srv.run_pending()
    t.note("stride order", seen)
    t.stats("stride", srv)
    srv.close()


def sc_breaker(P, t, clock):
    br = P.serving.CircuitBreaker(window=10, min_calls=3, failure_rate=0.6,
                                  cooldown=10.0, probes=1, clock=clock)
    srv = _server(P, clock, capacity=2, buckets=[4], breaker=br,
                  default_deadline=60.0, name="chaos")
    for _ in range(2):
        t.call("healthy", lambda: srv.predict(_rows(2)))
    P.faults.arm(P.faults.FaultPlan().arm("serving.forward", nth=1,
                                          count=3))
    for _ in range(3):
        t.call("faulted", lambda: srv.predict(_rows(2)))
    t.note("state after faults", br.state)
    t.call("open", lambda: srv.predict(_rows(2)))
    t.note("readyz open", srv.readyz())
    clock.advance(10.0)
    t.note("state after cool-down", br.state)
    t.call("half-open probe", lambda: srv.predict(_rows(2, fill=5.0)))
    t.note("state after probe", br.state)
    t.note("fired", P.faults.stats()["fired"])
    t.stats("breaker", srv)
    srv.close()

    fallback = P.serving.CallableBackend(
        lambda a: [np.zeros_like(a["data"])])
    br = P.serving.CircuitBreaker(window=4, min_calls=2, failure_rate=1.0,
                                  cooldown=100.0, clock=clock)
    srv = P.serving.InferenceServer(P.serving.CallableBackend(_echo),
                                    fallback=fallback, breaker=br,
                                    workers=0, clock=clock, name="degraded")
    srv.warm_up()
    P.faults.arm(P.faults.FaultPlan().arm("serving.forward", nth=1,
                                          count=2))
    for _ in range(3):
        t.call("degraded", lambda: srv.predict(_rows(1)))
    t.note("healthz degraded", srv.healthz())
    t.stats("fallback", srv)
    srv.close()


def sc_coalescing(P, t, clock):
    dispatched = []
    srv = _server(P, clock, fn=_tracking(dispatched), row=(3,),
                  max_batch=8, name="coal")
    dispatched.clear()                        # drop the warm-up probes
    reqs = [srv.submit(_rows(1, fill=float(i))) for i in range(5)]
    reqs.append(srv.submit(np.arange(9, dtype=np.float32).reshape(3, 3)))
    reqs += [srv.submit(_rows(1, fill=10.0 + i)) for i in range(3)]
    srv.run_pending()
    for i, req in enumerate(reqs):
        t.call(f"r{i}", lambda req=req: srv.result(req))
    t.note("dispatched", dispatched)
    t.stats("coalescing", srv)
    srv.close()


def sc_unwarmed_strict(P, t, clock):
    srv = _server(P, clock, row=(3,), max_batch=4, name="strict")
    t.call("warmed", lambda: srv.predict(_rows(2)))
    t.call("unwarmed", lambda: srv.predict(
        np.ones((1, 3), np.float64)))
    pair = [srv.submit(np.ones((1, 3), np.float64)) for _ in range(2)]
    srv.run_pending()
    for i, req in enumerate(pair):
        t.call(f"coalesced unwarmed {i}", lambda req=req: srv.result(req))
    t.note("circuit", srv.breaker.state)
    t.stats("strict", srv)
    srv.close()


def _segment_sum(arrays):
    data = np.asarray(arrays["data"], np.float32)
    seg = np.asarray(arrays["segment_ids"])
    assert seg.shape == data.shape[:2]
    return [data * 3.0 + 1.0]


def sc_pad_waste(P, t, clock):
    srv = _server(P, clock, row=(3,), max_batch=4, name="dense")
    reqs = [srv.submit(_rows(1, fill=float(i))) for i in range(3)]
    srv.run_pending()
    for i, req in enumerate(reqs):
        t.call(f"dense {i}", lambda req=req: srv.result(req))
    t.stats("dense", srv)
    srv.close()

    # bench_ragged.py's packing at its own sizes is a timing harness; the
    # packer's bitwise scatter is held here at toy lengths
    srv = P.serving.InferenceServer(
        P.serving.CallableBackend(_segment_sum, input_specs={"data": (8, 2)},
                                  pack_axis=1, accepts_segment_ids=True),
        name="packed", workers=0, clock=clock, max_batch=4)
    srv.warm_up()
    lengths = [5, 4, 3, 2, 6, 1]
    arrays = [np.arange(n * 2, dtype=np.float32).reshape(1, n, 2) + 10.0 * i
              for i, n in enumerate(lengths)]
    reqs = [srv.submit({"data": a}) for a in arrays]
    t.call("too long", lambda: srv.submit(
        {"data": np.zeros((1, 9, 2), np.float32)}))
    srv.run_pending()
    for i, (arr, req) in enumerate(zip(arrays, reqs)):
        got = t.call(f"packed {i}", lambda req=req: srv.result(req))
        np.testing.assert_array_equal(got[0], arr * 3.0 + 1.0)
    t.stats("packed", srv)
    srv.close()


def sc_probes(P, t, clock):
    srv = P.serving.InferenceServer(P.serving.CallableBackend(_echo),
                                    workers=0, clock=clock, capacity=1,
                                    name="probe")
    t.note("readyz cold", srv.readyz())
    srv.warm_up()
    t.note("readyz warm", srv.readyz())
    t.note("healthz warm", srv.healthz())
    srv.submit(_rows(1))
    t.note("readyz full", srv.readyz())
    srv.run_pending()
    clock.advance(7.0)
    t.note("healthz served", srv.healthz())
    srv.close()
    t.note("healthz closed", srv.healthz())
    t.call("closed", lambda: srv.submit(_rows(1)))
    t.stats("probes", srv)


def sc_drain(P, t, clock):
    srv = _server(P, clock, name="drain")
    srv.install_signal_handlers(signals=(signal.SIGTERM,))
    queued = [srv.submit(_rows(1, fill=float(i))) for i in range(2)]
    P.supervisor.signal_runtime().deliver(signal.SIGTERM)
    t.note("readyz draining", srv.readyz())
    t.call("while draining", lambda: srv.submit(_rows(1)))
    srv.drain()
    for i, req in enumerate(queued):
        t.call(f"drained {i}", lambda req=req: srv.result(req))
    t.note("endpoints", sorted(P.serving.endpoints()))
    t.note("healthz", srv.healthz())
    t.stats("drain", srv)


SCENARIOS = {"admission": sc_admission, "deadlines": sc_deadlines,
             "tenants": sc_tenants, "breaker": sc_breaker,
             "coalescing": sc_coalescing,
             "unwarmed_strict": sc_unwarmed_strict,
             "pad_waste": sc_pad_waste, "probes": sc_probes,
             "drain": sc_drain}


def _clean(P):
    P.faults.disarm()
    P.resilience.reset_stats()
    P.set_default_policy(None)
    for srv in P.serving.endpoints().values():
        srv.close()


def _drive(P, scenario):
    _clean(P)
    trace = Trace()
    try:
        scenario(P, trace, FakeClock())
    finally:
        _clean(P)
    return trace.events


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_server_matches_jax_package(name, monkeypatch):
    if name == "unwarmed_strict":
        monkeypatch.setenv("MXTPU_RETRACE_STRICT", "1")
    jax_events = _drive(_jax_pkg(), SCENARIOS[name])
    port_events = _drive(_port_pkg(), SCENARIOS[name])
    assert [e[:2] for e in port_events] == [e[:2] for e in jax_events]
    for mine, theirs in zip(port_events, jax_events):
        assert mine == theirs, mine[0]


def test_warmup_compile_counters_are_the_ports_builds():
    """The two counters that differ in meaning: in the port they count
    kernel libraries built or found built during the warm-up, so a
    server over a numpy function counts none."""
    P = _port_pkg()
    srv = _server(P, FakeClock(), row=(3,), max_batch=4, name="counters")
    try:
        st = srv.stats()
        assert st["warmed_buckets"] == 3
        assert st["warmup_cache_hits"] == 0 and st["warmup_compiles"] == 0
    finally:
        srv.close()


def test_batch_signature_matches_jax_package():
    from mxnet_tpu.compiler import batch_signature as jax_sig
    from mxnet_tpu_torch.compiler import batch_signature as port_sig
    feed = {"data": np.zeros((4, 3), np.float32),
            "lengths": np.zeros((4,), np.int32)}
    for kw in ({}, {"route": "fallback"}, {"symbolic_rows": 8}):
        assert port_sig(feed, **kw) == jax_sig(feed, **kw)


def test_config_knobs_match_jax_package(monkeypatch):
    from mxnet_tpu import config as jax_config
    from mxnet_tpu_torch import config as port_config
    for name, knob in port_config.KNOBS.items():
        if name in jax_config.KNOBS:
            assert knob[:3] == jax_config.KNOBS[name][:3], name
    monkeypatch.setenv("MXNET_MAX_BATCH", "8")
    monkeypatch.setenv("MXTPU_BATCH_WAIT_MS", "0.5")
    for name in ("MXTPU_MAX_BATCH", "MXTPU_BATCH_WAIT_MS", "MXTPU_RAGGED"):
        assert port_config.get(name) == jax_config.get(name)


def test_waiting_pieces_raise():
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match="A12"):
        mxt.serving.SymbolicJitBackend(lambda a: a, 4, {"data": (3,)})
    net = mxt.sym.FullyConnected(mxt.sym.var("data"), num_hidden=2)
    mod = mxt.mod.Module(net, label_names=[], context=mxt.cpu())
    mod.bind(data_shapes=[("data", (2, 3))], for_training=False)
    mod.init_params()
    with pytest.raises(MXNetError, match="A12"):
        mod.as_serving_backend(quant=True)


# ---------------------------------------------------------------------------
# the executor repair: a batch of another size than the bound one
# ---------------------------------------------------------------------------

def _fc_outputs(mx, ctx, rows):
    net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2,
                                name="fc")
    mod = mx.mod.Module(net, label_names=[], context=ctx)
    mod.bind(data_shapes=[("data", (4, 3))], for_training=False)
    mod.init_params(arg_params={
        "fc_weight": mx.nd.array(np.arange(6, dtype=np.float32)
                                 .reshape(2, 3) / 7.0, ctx=ctx),
        "fc_bias": mx.nd.array(np.array([0.5, -0.25], np.float32),
                               ctx=ctx)})
    rng = np.random.RandomState(3)
    outs = []
    for n in rows:
        x = rng.rand(n, 3).astype(np.float32)
        mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=ctx)]),
                    is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    return outs


def test_module_answers_batches_of_another_size():
    import mxnet_tpu
    rows = (1, 2, 3, 4, 1)
    theirs = _fc_outputs(mxnet_tpu, mxnet_tpu.cpu(), rows)
    mine = _fc_outputs(mxt, mxt.cpu(), rows)
    for n, a, b in zip(rows, mine, theirs):
        assert a.shape == b.shape == (n, 2)
        np.testing.assert_allclose(a, b, rtol=0, atol=EXEC_TOL)

"""The port's parameter server (``deeplearning4j_tpu_torch/scaleout/
param_server.py``) against the JAX package's: the store's push/pull
semantics bitwise, the TCP wire both ways (a port client against a JAX
``TcpParameterServer`` and a JAX client against the port's, on every
codec: pulled params, versions, pushes and the wire counters identical to
the JAX client against the JAX server), idempotent retried pushes under
the drop fault, negotiation, staleness, trace stitching, the ``--serve``
child, and ``ParameterServerParallelWrapper`` with one worker at float64
against the JAX wrapper (1e-10).  The store and the wire are host numpy,
so every comparison but the wrapper's is exact."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmon
from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu.scaleout import param_server as jps
from deeplearning4j_tpu_torch import monitor as pmon
from deeplearning4j_tpu_torch.resilience import faults as pfaults
from deeplearning4j_tpu_torch.scaleout import param_server as pps

ROOT = Path(__file__).resolve().parents[1]
PKG = {"jax": jps, "port": pps}
WIRE = "scaleout_wire_bytes_total"


@pytest.fixture(autouse=True)
def _isolated():
    for mod in (jmon, pmon):
        mod.reset()
    for mod in (jfaults, pfaults):
        mod.reset()
    yield
    for mod in (jmon, pmon):
        mod.reset()
    for mod in (jfaults, pfaults):
        mod.reset()


def _server(pkg, dim=8, chunk=4, scale=1.0, init=None):
    mod = PKG[pkg]
    store = mod.ParameterServer(np.zeros(dim) if init is None else init,
                                update_scale=scale, chunk_size=chunk)
    return store, mod.TcpParameterServer(store)


def _wire_counts():
    """The wire counter's values summed over both packages' registries
    (a same-package run counts client and server into one registry, a
    mixed run into two)."""
    out = {}
    for mod in (jmon, pmon):
        snap = mod.counter(WIRE, "").snapshot()["values"]
        for key, v in snap.items():
            k = json.dumps(key, sort_keys=True, default=str)
            out[k] = out.get(k, 0.0) + v
    return out


# ------------------------------------------------------------ the store

def test_store_push_pull_semantics_match_jax():
    rng = np.random.RandomState(0)
    init = rng.randn(3, 7)
    stores = [mod.ParameterServer(init, update_scale=0.5, chunk_size=4)
              for mod in (jps, pps)]
    for store in stores:
        assert store.num_chunks == 6 and store.dim == 21
    for step in range(3):
        delta = rng.randn(3, 7)
        chunk = rng.randn(4)
        versions = [s.push(delta) for s in stores]
        for s in stores:
            s.push_chunk(2, chunk)
        versions += [s.commit_push() for s in stores]
        assert versions[0] == versions[1] and versions[2] == versions[3]
        pulls = [s.pull() for s in stores]
        assert pulls[0].shape == (3, 7)
        np.testing.assert_array_equal(pulls[1], pulls[0])
        np.testing.assert_array_equal(stores[1].pull_chunk(5),
                                      stores[0].pull_chunk(5))
    assert stores[1].pushes == stores[0].pushes == 6
    assert stores[1].version == 6
    for s in stores:
        with pytest.raises(ValueError, match="broadcast"):
            s.push(np.ones(1))
        with pytest.raises(ValueError, match="chunk 5 carries"):
            s.push_chunk(5, np.ones(4))
    assert pmon.histogram("server_lock_wait_seconds", "").stats()[
        "count"] > 0


# ------------------------------------------------------- wire interop

CODECS = [None, "f32", "int8", "topk8"]


def _session(server_pkg, client_pkg, codec):
    """One client session against one server: three pushes, a pull, the
    counters, all as plain values."""
    dim = 150
    rng = np.random.RandomState(5)
    init = rng.randn(dim)
    store, srv = _server(server_pkg, dim=dim, chunk=64, scale=0.5,
                         init=init)
    deltas = [rng.randn(dim) * 0.1 for _ in range(3)]
    out = {}
    try:
        with PKG[client_pkg].TcpParameterServerClient(
                srv.host, srv.port, codec=codec) as c:
            acks = []
            for d in deltas:
                if codec is None:
                    c.push(d)
                else:
                    acks.append(c.push_delta(d))
            pulled = c.pull() if codec is None else c.pull_coded()
            out.update(acks=acks, pulled=pulled, pushes=c.pushes,
                       version=c.version() if codec else None,
                       staleness=c.staleness(),
                       codec_id=c.codec_id, chunk_size=c.chunk_size)
        out.update(store=store.pull(), store_pushes=store.pushes,
                   wire=_wire_counts())
    finally:
        srv.close()
    return out


@pytest.fixture(scope="module")
def reference_sessions():
    jmon.reset()
    pmon.reset()
    ref = {}
    for codec in CODECS:
        jmon.reset()
        pmon.reset()
        ref[codec] = _session("jax", "jax", codec)
    return ref


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: c or "f64")
@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax"),
                                           ("port", "port")])
def test_wire_interop_matches_the_jax_pair(reference_sessions, server,
                                           client, codec):
    want = reference_sessions[codec]
    got = _session(server, client, codec)
    np.testing.assert_array_equal(got["pulled"], want["pulled"])
    np.testing.assert_array_equal(got["store"], want["store"])
    for key in ("acks", "pushes", "version", "staleness", "codec_id",
                "chunk_size", "store_pushes", "wire"):
        assert got[key] == want[key], key
    assert got["store_pushes"] == 3
    assert sum(got["wire"].values()) > 0


def test_serve_child_speaks_to_both_clients():
    """``python -m deeplearning4j_tpu_torch.scaleout.param_server --serve``
    prints its address and serves a JAX client and a port client."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.scaleout."
         "param_server", "--serve", "--dim", "6", "--update-scale", "0.5",
         "--chunk-size", "4"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline())
        with jps.TcpParameterServerClient(info["host"], info["port"]) as a, \
                pps.TcpParameterServerClient(info["host"], info["port"],
                                             codec="f32") as b:
            np.testing.assert_array_equal(a.pull(), np.zeros(6))
            a.push(np.ones(6))
            b.push_delta(np.full(6, 3.0))
            np.testing.assert_array_equal(b.pull_coded(), np.full(6, 2.0))
            assert b.chunk_size == 4 and a.pushes == 2
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# ------------------------------------------------- idempotency, faults

@pytest.mark.parametrize("server", ["jax", "port"])
@pytest.mark.parametrize("codec", [None, "int8"], ids=["raw", "int8"])
def test_retried_push_is_idempotent_under_the_drop_fault(server, codec):
    """The port client's drop fault severs the socket after the frame is
    on the wire and before the ack; the retry re-sends the same request
    id (and records) and the server applies it once."""
    store, srv = _server(server, dim=8, chunk=4)
    delta = np.linspace(-1.0, 1.0, 8)
    try:
        with pps.TcpParameterServerClient(srv.host, srv.port,
                                          codec=codec) as c:
            if codec:
                c.version()                 # negotiate before arming
            pfaults.configure(drop_connection=1)
            if codec:
                assert c.push_delta(delta) == 1
            else:
                c.push(delta)
        assert store.pushes == 1 and store.version == 1
        if codec:
            assert np.abs(store.pull() - delta).max() <= 2.0 / 510.0 * 1.01
        else:
            np.testing.assert_array_equal(store.pull(), delta)
        assert pmon.counter("param_server_retries_total", "").value() >= 1
        smon = jmon if server == "jax" else pmon
        dup = smon.counter("param_server_duplicate_pushes_total", "")
        # the first attempt lands before the teardown: every chunk (or
        # the raw push) is deduplicated on the retry
        assert dup.value() == (2 if codec else 1)
    finally:
        srv.close()


def test_negotiation_and_rejections():
    store, srv = _server("port", dim=8, chunk=4)
    srv.CAPABILITIES = pps._compression.CAP_F32
    try:
        with pps.TcpParameterServerClient(srv.host, srv.port,
                                          codec="auto") as c:
            c.version()
            assert c.codec_id == pps._compression.CODEC_F32
            assert c.chunk_size == 4
        with pps.TcpParameterServerClient(srv.host, srv.port,
                                          codec="int8") as c:
            with pytest.raises(ValueError, match="no common codec"):
                c.version()
        with pps.TcpParameterServerClient(srv.host, srv.port) as old:
            with pytest.raises(ValueError, match="without a codec"):
                old.push_delta(np.ones(8))
            with pytest.raises(ValueError, match="param shape"):
                old.push(np.ones(3))
    finally:
        srv.close()


def test_staleness_tracks_versions_and_resets_on_pull():
    store, srv = _server("port", dim=8, chunk=4)
    try:
        with pps.TcpParameterServerClient(srv.host, srv.port,
                                          codec="int8") as a, \
                pps.TcpParameterServerClient(srv.host, srv.port,
                                             codec="int8") as b:
            b.pull_coded()
            assert b.staleness() == 0
            for _ in range(3):
                a.push_delta(np.ones(8) * 0.01)
            b.push_delta(np.ones(8) * 0.01)
            assert b.staleness() == 4
            b.pull_coded()
            assert b.staleness() == 0
        assert "scaleout_staleness" in pmon.prometheus_text()
    finally:
        srv.close()


def test_retried_compressed_push_stitches_one_trace():
    store, srv = _server("port", dim=8, chunk=4)
    ctx = pmon.TraceContext(pmon.new_trace_id(),
                            pmon.tracer().next_span_id())
    tok = pmon.attach(ctx)
    try:
        with pps.TcpParameterServerClient(srv.host, srv.port,
                                          codec="int8") as c:
            c.version()
            pfaults.configure(drop_connection=1)
            c.push_delta(np.ones(8))
            dump = c.dump_trace()
    finally:
        pmon.detach(tok)
        srv.close()
    events = pmon.tracer().events(trace_id=f"{ctx.trace_id:032x}")
    client_push = [e for e in events
                   if e["name"] == "param_server_client/push"]
    server_push = [e for e in events if e["name"] == "param_server/push"]
    assert len(client_push) == 1
    assert 1 <= len(server_push) <= 2
    assert all(e["parent"] == client_push[0]["id"] for e in server_push)
    assert dump["pid"] == os.getpid() and dump["events"]


# ------------------------------------------------------------ the wrapper

def _iris_pair(seed=3, dtype="float64", hidden=6):
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.layers import core as jcore
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (JConf.builder().seed(seed).updater("sgd").learning_rate(0.1)
            .weight_init("xavier").dtype(dtype).activation("tanh").list()
            .layer(jcore.DenseLayer(n_in=4, n_out=hidden))
            .layer(jcore.OutputLayer(n_in=hidden, n_out=3,
                                     activation="softmax", loss="mcxent"))
            .build())
    jnet = JNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    load_jax_params(pnet, np.asarray(jnet.get_flat_params()))
    return jnet, pnet


@pytest.mark.parametrize("transport", ["in_process", "tcp"])
def test_wrapper_single_worker_matches_jax_and_the_plain_fit(transport):
    """One worker with scale 1: pull, train, push reproduces the
    sequential fit; the port's wrapper holds the JAX wrapper's params at
    1e-10 (float64) and its own plain fit bitwise, in process and over
    the port's TCP server."""
    from deeplearning4j_tpu.datasets.iris import iris_dataset as jiris
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu_torch.datasets.iris import iris_dataset
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    jnet, pnet = _iris_pair()
    ref = pnet.clone()
    jw = jps.ParameterServerParallelWrapper(jnet, num_workers=1)
    jw.fit(JList(jiris(), batch_size=50, shuffle=False), epochs=3)
    srv = None
    if transport == "tcp":
        store = pps.ParameterServer(pnet.get_flat_params())
        srv = pps.TcpParameterServer(store)
        pw = pps.ParameterServerParallelWrapper(
            pnet, num_workers=1, server_address=(srv.host, srv.port))
    else:
        pw = pps.ParameterServerParallelWrapper(pnet, num_workers=1)
    try:
        pw.fit(ListDataSetIterator(iris_dataset(), batch_size=50,
                                   shuffle=False), epochs=3)
    finally:
        pw.close()
        if srv is not None:
            srv.close()
    np.testing.assert_allclose(pw.model.get_flat_params(),
                               np.asarray(jw.model.get_flat_params()),
                               rtol=1e-10, atol=1e-10)
    ref.fit(ListDataSetIterator(iris_dataset(), batch_size=50,
                                shuffle=False), epochs=3, ingest="batch")
    np.testing.assert_array_equal(pw.model.get_flat_params(),
                                  ref.get_flat_params())


def test_wrapper_async_workers_converge():
    """Three worker threads against the in-process store (staleness by
    scheduling) reach the reference's convergence target on iris."""
    from deeplearning4j_tpu_torch.datasets.iris import iris_dataset
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    _, net = _iris_pair(seed=7, dtype="float32", hidden=8)
    ds = iris_dataset()
    it = ListDataSetIterator(ds, batch_size=30, shuffle=True, seed=0)
    psw = pps.ParameterServerParallelWrapper(net, num_workers=3)
    s0 = psw.model.score(ds)
    for _ in range(6):
        psw.fit(it, epochs=20)
        s1 = psw.model.score(ds)
        acc = float(np.mean(psw.model.predict(ds.features).numpy()
                            == np.argmax(np.asarray(ds.labels), 1)))
        if s1 < s0 * 0.6 and acc > 0.8:
            break
    else:
        raise AssertionError(f"async PS failed to converge: {s0} -> {s1}, "
                             f"acc {acc}")
    assert psw.server.pushes >= 40
    with pytest.raises(ValueError, match="TCP transport"):
        pps.ParameterServerParallelWrapper(net, codec="int8")


def test_wrapper_coded_staleness_bounded_training_converges():
    from deeplearning4j_tpu_torch.scaleout.async_trainer import (
        build_net, eval_accuracy, make_batches)
    net = build_net(seed=11, lr=0.5, device="cpu")
    store = pps.ParameterServer(net.get_flat_params(), update_scale=0.5,
                                chunk_size=64)
    srv = pps.TcpParameterServer(store)
    try:
        with pps.ParameterServerParallelWrapper(
                net, num_workers=2, batches_per_push=2,
                server_address=(srv.host, srv.port), codec="topk8",
                staleness_bound=4) as psw:
            batches = make_batches(16, 32, seed=100)
            acc = 0.0
            for _ in range(12):
                psw.fit(batches)
                acc = eval_accuracy(psw.model)
                if acc > 0.8:
                    break
            assert acc > 0.8, f"coded wrapper failed to converge: {acc}"
            assert store.pushes >= 16
            with pytest.raises(ValueError, match="server-side"):
                pps.ParameterServerParallelWrapper(
                    net, server_address=(srv.host, srv.port),
                    update_scale=0.5)
    finally:
        srv.close()

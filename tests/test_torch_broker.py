"""The port's stream broker (``deeplearning4j_tpu_torch/streaming/broker.py``)
on the CPU: the port twins of every case of ``tests/test_broker.py``, of
the broker's load shedding (``tests/test_resilience.py``) and of its
trace propagation (``tests/test_tracing.py``), and the two packages
against each other: the same frames on the wire byte for byte, the same
key partitioning, a JAX producer against the port's broker and a port
consumer on the JAX broker, and a ``log_dir`` written by one package
byte for byte the other's and reopened by it.

Every wait is bounded: sockets carry timeouts, ``poll`` a timeout,
``_wait`` a deadline and every child process a deadline.
"""

import filecmp
import json
import os
import socket
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.streaming import broker as jbroker
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import inputs
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.streaming import (BrokerRecordSource,
                                                CsvRecordConverter,
                                                StreamBroker,
                                                StreamConsumer,
                                                StreamProducer,
                                                StreamingPipeline)
from deeplearning4j_tpu_torch.streaming import broker as pbroker

ROOT = Path(__file__).resolve().parents[1]


def _wait(predicate, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


# ----------------------------------------------------------- log semantics

def test_produce_fetch_append_log_replayable():
    broker = StreamBroker()
    try:
        prod = StreamProducer(broker.host, broker.port)
        assert prod.produce("t", ["a", "b", "c"], partition=0) == (0, 0)
        assert prod.produce("t", ["d"], partition=0)[1] == 3
        recs, nxt, end = broker.fetch("t", 0, 0, 10)
        assert recs == ["a", "b", "c", "d"] and nxt == 4 and end == 4
        assert broker.fetch("t", 0, 1, 2)[0] == ["b", "c"]
        prod.close()
    finally:
        broker.close()


def test_partitioning_explicit_keyed_round_robin():
    broker = StreamBroker()
    try:
        prod = StreamProducer(broker.host, broker.port)
        prod.create_topic("multi", partitions=3)
        p1, _ = prod.produce("multi", ["x"], key="user-42")
        p2, _ = prod.produce("multi", ["y"], key="user-42")
        assert p1 == p2
        assert {prod.produce("multi", [f"r{i}"])[0]
                for i in range(6)} == {0, 1, 2}
        assert sum(broker.end_offsets("multi").values()) == 8
        prod.close()
    finally:
        broker.close()


def test_consumer_group_commit_and_resume():
    broker = StreamBroker()
    try:
        prod = StreamProducer(broker.host, broker.port)
        prod.create_topic("jobs", partitions=1)
        prod.produce("jobs", [f"job-{i}" for i in range(10)], partition=0)
        c1 = StreamConsumer(broker.host, broker.port, "g1", ["jobs"])
        first = c1.poll(max_records=4, timeout=2.0)
        assert [r for (_, _, _, r) in first] == [f"job-{i}"
                                                for i in range(4)]
        c1.commit()
        c1.close()
        c2 = StreamConsumer(broker.host, broker.port, "g1", ["jobs"])
        rest = c2.poll(max_records=100, timeout=2.0)
        assert [r for (_, _, _, r) in rest] == [f"job-{i}"
                                               for i in range(4, 10)]
        c3 = StreamConsumer(broker.host, broker.port, "g2", ["jobs"])
        assert len(c3.poll(max_records=100, timeout=2.0)) == 10
        c2.close()
        c3.close()
        prod.close()
    finally:
        broker.close()


def test_consumer_group_rebalance_splits_and_reclaims():
    broker = StreamBroker(session_timeout=30.0)
    try:
        prod = StreamProducer(broker.host, broker.port)
        prod.create_topic("rb", partitions=4)
        c1 = StreamConsumer(broker.host, broker.port, "g", ["rb"],
                            member_id="m1", heartbeat_interval=0.05)
        assert len(c1.assignment) == 4
        c2 = StreamConsumer(broker.host, broker.port, "g", ["rb"],
                            member_id="m2", heartbeat_interval=0.05)

        def _polled_down_to(consumer, n):
            consumer.poll(timeout=0.0)
            return len(consumer.assignment) == n

        assert _wait(lambda: _polled_down_to(c1, 2), timeout=5.0)
        a1, a2 = set(c1.assignment), set(c2.assignment)
        assert len(a1) == 2 and len(a2) == 2 and not (a1 & a2)
        assert a1 | a2 == {("rb", p) for p in range(4)}
        c2.close()
        assert _wait(lambda: _polled_down_to(c1, 4), timeout=5.0)
        c1.close()
        prod.close()
    finally:
        broker.close()


def test_stale_member_commit_is_fenced():
    broker = StreamBroker()
    try:
        prod = StreamProducer(broker.host, broker.port)
        prod.create_topic("f", partitions=1)
        prod.produce("f", [f"r{i}" for i in range(10)], partition=0)
        c1 = StreamConsumer(broker.host, broker.port, "g", ["f"],
                            member_id="m1", heartbeat_interval=999)
        c1.poll(max_records=3, timeout=2.0)
        c2 = StreamConsumer(broker.host, broker.port, "g", ["f"],
                            member_id="m2", heartbeat_interval=999)
        broker.commit("g", {"f": {0: 9}}, member="m2",
                      generation=c2.generation)
        assert broker.commit("g", {"f": {0: 3}}, member="m1",
                             generation=c1.generation) is False
        assert broker.commit("g", {"f": {0: 3}}, member="ghost",
                             generation=99) is False
        assert broker.committed("g", "f")[0] == 9
        assert c1.commit_offsets({"f": {0: 3}}) is False
        assert c1.generation == 3
        assert broker.committed("g", "f")[0] == 9
        assert broker.commit("g2", {"f": {0: 5}}) is True
        c1.close()
        c2.close()
        prod.close()
    finally:
        broker.close()


def test_broker_persistence_survives_restart(tmp_path):
    log_dir = str(tmp_path / "wal")
    broker = StreamBroker(log_dir=log_dir)
    prod = StreamProducer(broker.host, broker.port)
    prod.create_topic("p", partitions=2)
    prod.produce("p", ["a", "b"], partition=0)
    prod.produce("p", ["c"], partition=1)
    c = StreamConsumer(broker.host, broker.port, "g", ["p"])
    c.poll(max_records=10, timeout=2.0)
    c.commit()
    c.close()
    prod.close()
    broker.close()
    broker2 = StreamBroker(log_dir=log_dir)
    try:
        recs, _, end = broker2.fetch("p", 0, 0, 10)
        assert recs == ["a", "b"] and end == 2
        c2 = StreamConsumer(broker2.host, broker2.port, "g", ["p"])
        assert c2.poll(max_records=10, timeout=0.5) == []
        c2.close()
    finally:
        broker2.close()


_CONSUMER_SCRIPT = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
from {package}.streaming.broker import StreamConsumer

host, port, batches = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
c = StreamConsumer(host, port, "workers", ["events"])
seen = []
for _ in range(batches):
    recs = c.poll(max_records=5, timeout=5.0)
    if not recs:
        break
    seen.extend(r for (_, _, _, r) in recs)
    c.commit()
print(json.dumps(seen), flush=True)
os._exit(0)
"""


def test_cross_process_produce_kill_resume():
    """A consumer process of the port commits 4 batches of 5 and dies
    without leaving; a second resumes at the committed offset: every
    record exactly once across the two lifetimes."""
    broker = StreamBroker(session_timeout=2.0)
    try:
        prod = StreamProducer(broker.host, broker.port)
        prod.create_topic("events", partitions=1)
        records = [f"ev-{i:03d}" for i in range(40)]
        prod.produce("events", records, partition=0)
        script = _CONSUMER_SCRIPT.format(repo=str(ROOT),
                                         package="deeplearning4j_tpu_torch")

        def run_consumer(batches):
            out = subprocess.run(
                [sys.executable, "-c", script, broker.host,
                 str(broker.port), str(batches)],
                capture_output=True, text=True, timeout=60)
            assert out.returncode == 0, out.stderr[-800:]
            return json.loads(out.stdout.strip().splitlines()[-1])

        assert run_consumer(4) == records[:20]
        assert run_consumer(100) == records[20:]
        prod.close()
    finally:
        broker.close()


def _net(n_in=2, n_classes=2, seed=7):
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater("sgd").learning_rate(0.2)
            .activation("tanh").weight_init("xavier").list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=n_classes))
            .set_input_type(inputs.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


class _TrackingConverter(CsvRecordConverter):
    """Records every id it converts: the delivered-record ledger."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.ids = []

    def convert(self, record):
        self.ids.append(int(record.split(",")[0]))
        return super().convert(",".join(record.split(",")[1:]))


def test_pipeline_trains_from_broker_and_resumes():
    broker = StreamBroker()
    try:
        prod = StreamProducer(broker.host, broker.port)
        prod.create_topic("train", partitions=1)
        rng = np.random.RandomState(3)
        X = rng.randn(100, 2)
        y = (X[:, 0] > 0).astype(int)
        rows = [f"{i},{a:.4f},{b:.4f},{int(c)}"
                for i, ((a, b), c) in enumerate(zip(X, y))]
        prod.produce("train", rows[:60], partition=0)

        def make_pipe(net):
            conv = _TrackingConverter(label_index=-1, num_classes=2)
            src = BrokerRecordSource(StreamConsumer(
                broker.host, broker.port, "trainers", ["train"],
                heartbeat_interval=0.2), fetch_size=16)
            return (StreamingPipeline(net, src, conv, mode="fit",
                                      batch_size=10, flush_interval=0.2,
                                      device="cpu"), conv, src)

        net = _net()
        pipe1, conv1, src1 = make_pipe(net)
        with pipe1:
            assert _wait(lambda: pipe1.records_processed >= 60)
        src1.close()
        assert conv1.ids == list(range(60)) and not pipe1.errors
        prod.produce("train", rows[60:], partition=0)
        pipe2, conv2, src2 = make_pipe(net)
        with pipe2:
            assert _wait(lambda: pipe2.records_processed >= 40)
        src2.close()
        assert conv2.ids == list(range(60, 100)) and not pipe2.errors
        probe = DataSet(X.astype(np.float32),
                        np.eye(2, dtype=np.float32)[y])
        assert float(net.score(probe)) < 0.6
        prod.close()
    finally:
        broker.close()


def test_broker_sheds_oldest_records_and_keeps_offsets_logical():
    monitor.reset()
    broker = StreamBroker(max_records_per_partition=10)
    try:
        broker.create_topic("t", 1)
        for i in range(25):
            broker.produce("t", [f"r{i}"], partition=0)
        assert broker.end_offsets("t") == {0: 25}
        recs, nxt, end = broker.fetch("t", 0, 0, max_records=100)
        assert recs == [f"r{i}" for i in range(15, 25)]
        assert (nxt, end) == (25, 25)
        recs, nxt, _ = broker.fetch("t", 0, 20, max_records=2)
        assert recs == ["r20", "r21"] and nxt == 22
        assert monitor.counter(
            "broker_records_dropped_total").value(topic="t") == 15
    finally:
        broker.close()


def test_broker_dispatch_joins_callers_trace():
    monitor.reset()
    broker = StreamBroker(port=0)
    try:
        prod = StreamProducer("127.0.0.1", broker.port)
        ctx = monitor.TraceContext(monitor.new_trace_id(), 0x5151)
        tok = monitor.attach(ctx)
        try:
            prod.create_topic("t", partitions=1)
            prod.produce("t", ["r1", "r2"], partition=0)
        finally:
            monitor.detach(tok)
        evs = monitor.tracer().events(trace_id=f"{ctx.trace_id:032x}",
                                      name="broker/")
        assert sorted(e["name"] for e in evs) == ["broker/create_topic",
                                                  "broker/produce"]
        assert all(e["parent"] == ctx.span_id for e in evs)
        prod.close()
    finally:
        broker.close()


def test_close_joins_every_broker_thread():
    broker = StreamBroker()
    prod = StreamProducer(broker.host, broker.port)
    cons = StreamConsumer(broker.host, broker.port, "g", ["t"])
    prod.produce("t", ["a"])
    assert _wait(lambda: len(broker._conns) == 2, timeout=5.0)
    threads = [t for t, _ in broker._conns.values()] + [broker._thread]
    broker.close(timeout=5.0)
    assert not any(t.is_alive() for t in threads)
    cons.close(leave=False)
    prod.close()


def test_broker_cli_child_serves_the_port():
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.streaming.broker",
         "--port", "0"], cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        addr = json.loads(line)
        prod = StreamProducer(addr["host"], addr["port"])
        assert prod.produce("cli", ["x", "y"], partition=0) == (0, 0)
        prod.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# ------------------------------------------------------ across packages

def _frames(mod, obj):
    a, b = socket.socketpair()
    try:
        a.settimeout(5.0)
        b.settimeout(5.0)
        mod._send_msg(a, obj)
        head = b.recv(4)
        n = int.from_bytes(head, "big")
        return head + pbroker._recv_exact(b, n)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("obj", [
    {"op": "produce", "topic": "t", "records": ["1,2", "é"],
     "partition": None, "key": "k"},
    {"op": "commit", "group": "g", "offsets": {"t": {"0": 3}},
     "member": "m", "generation": 2}, {}])
def test_frames_are_the_jax_packages_bytes(obj):
    assert _frames(pbroker, obj) == _frames(jbroker, obj)
    a, b = socket.socketpair()
    try:
        b.settimeout(5.0)
        jbroker._send_msg(a, obj)
        assert pbroker._recv_msg(b) == obj
    finally:
        a.close()
        b.close()


def test_key_partitioning_matches_jax():
    brokers = (jbroker.StreamBroker(), StreamBroker())
    try:
        for b in brokers:
            b.create_topic("k", 7)
        keys = [f"user-{i}" for i in range(50)] + ["", "é"]
        parts = [[b.produce("k", ["r"], key=key)[0] for key in keys]
                 for b in brokers]
        assert parts[0] == parts[1]
        rr = [[b.produce("k", ["r"])[0] for _ in range(10)]
              for b in brokers]
        assert rr[0] == rr[1]
    finally:
        for b in brokers:
            b.close()


def test_a_jax_producer_and_consumer_on_the_ports_broker():
    broker = StreamBroker()
    try:
        prod = jbroker.StreamProducer(broker.host, broker.port)
        prod.create_topic("x", partitions=2)
        assert prod.produce("x", ["a", "b"], key="user-1") == (
            zlib.crc32(b"user-1") % 2, 0)
        prod.produce("x", ["c"], partition=1)
        cons = jbroker.StreamConsumer(broker.host, broker.port, "g", ["x"])
        got = cons.poll(max_records=10, timeout=2.0)
        assert sorted(r for *_, r in got) == ["a", "b", "c"]
        cons.commit()
        assert broker.committed("g", "x") == broker.end_offsets("x")
        cons.close()
        prod.close()
    finally:
        broker.close()


def test_a_port_consumer_on_the_jax_broker():
    broker = jbroker.StreamBroker()
    try:
        prod = StreamProducer(broker.host, broker.port)
        prod.create_topic("y", partitions=3)
        for i in range(9):
            prod.produce("y", [f"r{i}"])
        src = BrokerRecordSource(StreamConsumer(
            broker.host, broker.port, "g", ["y"]), fetch_size=4)
        got = [src.poll(timeout=2.0) for _ in range(4)]
        src.on_batch_processed()          # commits the 4 delivered
        src.close()
        c2 = StreamConsumer(broker.host, broker.port, "g", ["y"])
        rest = [r for *_, r in c2.poll(max_records=100, timeout=2.0)]
        assert sorted(got + rest) == sorted(f"r{i}" for i in range(9))
        c2.commit()
        assert broker.committed("g", "y") == broker.end_offsets("y")
        c2.close()
        prod.close()
    finally:
        broker.close()


def _drive(mod, log_dir):
    """The same operations on a broker of ``mod`` over ``log_dir``."""
    broker = mod.StreamBroker(log_dir=log_dir)
    try:
        broker.create_topic("a", 2)
        broker.produce("a", ["1,2,3", "é,\"q\"", "{}"], partition=0)
        broker.produce("a", ["x"], key="k1")
        broker.produce("b-c", ["tail"])
        broker.commit("g1", {"a": {0: 2, 1: 1}})
        broker.commit("g2", {"b-c": {0: 1}})
    finally:
        broker.close()


def test_log_dir_files_are_the_jax_packages_and_reopen_both_ways(tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _drive(jbroker, jdir)
    _drive(pbroker, pdir)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir))
    assert "_group_offsets.json" in names and "a-0.jsonl" in names
    match, mismatch, errors = filecmp.cmpfiles(jdir, pdir, names,
                                               shallow=False)
    assert mismatch == [] and errors == [] and sorted(match) == names
    for mod, other in ((pbroker, jdir), (jbroker, pdir)):
        broker = mod.StreamBroker(log_dir=other)
        try:
            assert broker.fetch("a", 0, 0, 10)[0] == ["1,2,3", "é,\"q\"",
                                                      "{}"]
            assert broker.end_offsets("b-c") == {0: 1}
            assert broker.committed("g1", "a") == {0: 2, 1: 1}
        finally:
            broker.close()


def _drain(mod, broker):
    """Records a ``BrokerRecordSource`` of ``mod`` delivers when a member
    leaves while the source's consumer shares the group with it: the
    leave bumps the generation, and the source's next poll rejoins inside
    the consumer's heartbeat and fetches under the new generation."""
    broker.join_group("g", "a-leaver", ["t"])
    src = mod.BrokerRecordSource(mod.StreamConsumer(
        broker.host, broker.port, "g", ["t"], member_id="z-stays",
        heartbeat_interval=0.0), fetch_size=4)
    got = []
    for _ in range(3):
        rec = src.poll(timeout=0.5)
        if rec is not None:
            got.append(rec)
    broker.leave_group("g", "a-leaver")
    for _ in range(40):
        rec = src.poll(timeout=0.05)
        if rec is not None:
            got.append(rec)
    src.on_batch_processed()
    src.close()
    return got


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_rejoin_inside_poll_keeps_the_records_it_fetched(package):
    """The port's source delivers every record after a rejoin inside its
    poll, and commits the end offsets; the JAX source drops the records
    that poll fetched while the consumer's positions stay past them, so
    they are not delivered (ROADMAP C, reference-side caveat)."""
    mod = pbroker if package == "port" else jbroker
    broker = mod.StreamBroker()
    try:
        broker.create_topic("t", 2)
        for p in range(2):
            broker.produce("t", [f"p{p}-{i}" for i in range(6)], partition=p)
        got = _drain(mod, broker)
        every = sorted(f"p{p}-{i}" for p in range(2) for i in range(6))
        if package == "port":            # at least once: replays allowed
            assert sorted(set(got)) == every
            assert broker.committed("g", "t") == broker.end_offsets("t")
        else:
            assert sorted(set(got)) != every
    finally:
        broker.close()

"""The port's UI components, legacy listeners, ``ui.main`` and the
monitor's stats record against the JAX package's:

- every component's JSON and HTML (and a whole page) equal the JAX
  package's string for string, and each package's JSON loads in the other;
- ``write_png_gray`` bytes and ``activation_grid`` arrays are equal;
- ``HistogramIterationListener`` on the same weights (carried by the flat
  params, ``nn/jax_weights.py``'s path): at iteration 0 in fp32 the edges
  and counts equal the JAX listener's exactly; after 3 fitted steps the
  scores agree at 1e-5 (relative) and each tensor's bin counts within 0.5%
  of its size (f32 sums in another order move values near an edge);
- under ``mixed_bf16`` the JAX ``param_table`` hands bfloat16 arrays, whose
  ``np.histogram`` runs in bfloat16; the port histograms the same values
  as float32.  Pinned as a deliberate difference: the port's histogram is
  exactly ``np.histogram`` of the JAX bf16 values widened to float32, its
  edges lie within one bfloat16 step of the range of the JAX edges, and
  its counts move fewer values than 2% of the tensor's size;
- ``ConvolutionalIterationListener``'s PNGs decode to grids within 1 gray
  level of the JAX listener's (the per-channel min-max to uint8 can flip
  a level where the activations differ by rounding);
- ``ui.main.serve`` answers the JAX ``ui.main``'s routes with the same
  status, content type and top-level JSON keys;
- ``system_metrics_persistable``'s record has the JAX record's keys (the
  twin of ``tests/test_monitor.py``'s round trip through the overview).
"""

import json
import os
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import convolution as jconvl
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu.ui import legacy as jlegacy
from deeplearning4j_tpu.ui import main as jmain
from deeplearning4j_tpu.ui.storage import \
    InMemoryStatsStorage as JaxInMemoryStatsStorage
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.jax_weights import load_jax_params
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ui import components as comp
from deeplearning4j_tpu_torch.ui import legacy, main
from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.stats_listener import TYPE_ID
from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage

SCORE_RTOL = 1e-5
COUNT_SHARE = 0.005      # of a tensor's size, after 3 steps in fp32
BF16_COUNT_SHARE = 0.02  # the pinned mixed_bf16 difference


# --------------------------------------------------------------- components
def _components(mod):
    line = mod.ChartLine("loss <a&b>", mod.StyleChart(width=300, height=120))
    line.add_series("train", [0, 1, 2, 3], [2.5, 1.25, 0.75, 0.5])
    line.add_series("test", [0, 2], [2.0, 1.0])
    scatter = mod.ChartScatter("embed")
    scatter.add_series("pts", [0.1, -0.3, 2.0], [1.0, 0.5, -1.5])
    hist = mod.ChartHistogram("weights")
    for lo, hi, n in ((-1.0, -0.5, 3), (-0.5, 0.0, 10), (0.0, 0.5, 7)):
        hist.add_bin(lo, hi, n)
    table = mod.ComponentTable(["name", "value"],
                               [["lr", 0.01], ["<b>", "x&y"]],
                               mod.StyleTable(border_width=2))
    text = mod.ComponentText("Hello & <world>",
                             mod.StyleText(font_size=14, bold=True))
    empty = mod.ChartLine("nothing yet")
    div = mod.ComponentDiv([text, table])
    div.add(mod.ChartHistogram("no bins"))
    return [line, scatter, hist, table, text, empty, div]


def test_components_json_and_html_equal_the_jax_packages():
    for p, j in zip(_components(comp), _components(jcomp)):
        assert type(p).__name__ == type(j).__name__
        assert p.to_json() == j.to_json()
        assert p.render_html() == j.render_html()
    assert comp.render_page(_components(comp), "t") == \
        jcomp.render_page(_components(jcomp), "t")


def test_each_packages_json_loads_in_the_other():
    for p, j in zip(_components(comp), _components(jcomp)):
        from_jax = comp.Component.from_json(j.to_json())
        from_port = jcomp.Component.from_json(p.to_json())
        assert type(from_jax) is type(p)
        assert from_jax.to_json() == j.to_json()
        assert from_jax.render_html() == j.render_html()
        assert from_port.to_json() == p.to_json()
    with pytest.raises(ValueError):
        comp.Component.from_dict({"component_type": "Nope"})


def test_render_to_file_writes_the_jax_page(tmp_path):
    a = comp.render_to_file(_components(comp), str(tmp_path / "p.html"))
    b = jcomp.render_to_file(_components(jcomp), str(tmp_path / "j.html"))
    assert open(a, "rb").read() == open(b, "rb").read()


# --------------------------------------------------------------------- PNG
def _png_gray(path):
    """Decode an 8-bit grayscale PNG written with filter 0 on every row."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(
                body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert not raw[:, 0].any()
    return raw[:, 1:]


def test_png_bytes_and_grids_are_equal(tmp_path):
    act = np.random.RandomState(0).randn(6, 5, 7).astype(np.float32)
    act[:, :, 3] = 1.5                      # a flat channel
    grid, jgrid = legacy.activation_grid(act), jlegacy.activation_grid(act)
    assert np.array_equal(grid, jgrid) and grid.dtype == np.uint8
    a = legacy.write_png_gray(grid, str(tmp_path / "a.png"))
    b = jlegacy.write_png_gray(jgrid, str(tmp_path / "b.png"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert np.array_equal(_png_gray(a), grid)
    with pytest.raises(ValueError):
        legacy.activation_grid(act[0])
    with pytest.raises(ValueError):
        legacy.write_png_gray(act, str(tmp_path / "c.png"))


# --------------------------------------------------------------- listeners
def _lenet_conf():
    """LeNet's layers at narrow widths (3 and 4 filters, dense 16) on a
    12 x 12 input."""
    return (JaxConf.builder().seed(123).updater("adam").learning_rate(1e-2)
            .weight_init("xavier").activation("identity").list()
            .layer(jconvl.ConvolutionLayer(n_out=3, kernel_size=(3, 3)))
            .layer(jconvl.SubsamplingLayer(pooling_type="max"))
            .layer(jconvl.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                           activation="relu"))
            .layer(jcore.DenseLayer(n_out=16, activation="relu"))
            .layer(jcore.OutputLayer(n_out=5, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(jin.convolutional_flat(12, 12, 1)).build())


def _pair():
    conf = _lenet_conf()
    jnet = JaxNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    load_jax_params(pnet, jnet.params)
    return jnet, pnet


def _data(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 144).astype(np.float32),
            np.eye(5, dtype=np.float32)[rng.randint(0, 5, n)])


def test_histograms_equal_the_jax_listener_at_iteration_0():
    jnet, pnet = _pair()
    x, y = _data()
    pl, jl = (legacy.HistogramIterationListener(frequency=1, bins=20),
              jlegacy.HistogramIterationListener(frequency=1, bins=20))
    # score() needs a scored batch: one forward score, no update
    pnet._score = pnet.score(DataSet(x, y))
    jnet._score = jnet.score(JaxDataSet(x, y))
    pl.iteration_done(pnet, 0)
    jl.iteration_done(jnet, 0)
    assert sorted(pl.histograms) == sorted(jl.histograms)
    for name, (it, edges, counts) in pl.histograms.items():
        jit_, jedges, jcounts = jl.histograms[name]
        assert it == jit_ == 0
        assert np.array_equal(edges, jedges), name
        assert np.array_equal(counts, jcounts), name
    np.testing.assert_allclose(pl.scores[0][1], jl.scores[0][1],
                               rtol=SCORE_RTOL)
    assert pl.update_histograms == {} == jl.update_histograms


def test_histograms_after_three_steps_agree(tmp_path):
    jnet, pnet = _pair()
    pl = legacy.HistogramIterationListener(
        frequency=1, bins=20, output_file=str(tmp_path / "p.html"))
    jl = jlegacy.HistogramIterationListener(
        frequency=1, bins=20, output_file=str(tmp_path / "j.html"))
    pnet.set_listeners(pl)
    jnet.set_listeners(jl)
    for step in range(3):
        x, y = _data(seed=step)
        pnet.fit(DataSet(x, y))
        jnet.fit(JaxDataSet(x, y))
    assert [s[0] for s in pl.scores] == [s[0] for s in jl.scores] == \
        [1, 2, 3]
    np.testing.assert_allclose([s[1] for s in pl.scores],
                               [s[1] for s in jl.scores], rtol=SCORE_RTOL)
    sizes = {k: v.size for k, v in pnet.param_table().items()}
    for hists, jhists in ((pl.histograms, jl.histograms),
                          (pl.update_histograms, jl.update_histograms)):
        assert sorted(hists) == sorted(jhists) == sorted(sizes)
        for name, (it, _, counts) in hists.items():
            moved = np.abs(counts - jhists[name][2]).sum() / 2
            assert it == 3 and moved <= COUNT_SHARE * sizes[name], name
    titles = [json.loads(c.to_json()).get("title")
              for c in pl.components()]
    assert titles == [json.loads(c.to_json()).get("title")
                      for c in jl.components()]
    assert os.path.getsize(tmp_path / "p.html") > 0


def test_mixed_bf16_histograms_are_a_pinned_difference(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PRECISION", "mixed_bf16")
    jnet, pnet = _pair()
    assert pnet._pol().name == "mixed_bf16"
    x, y = _data()
    pl, jl = (legacy.HistogramIterationListener(frequency=1),
              jlegacy.HistogramIterationListener(frequency=1))
    pnet.set_listeners(pl)
    jnet.set_listeners(jl)
    pnet.fit(DataSet(x, y))
    jnet.fit(JaxDataSet(x, y))
    jtable = jnet.param_table()
    assert all(str(v.dtype) == "bfloat16" for v in jtable.values())
    ptable = pnet.param_table()
    assert all(v.dtype == np.float32 for v in ptable.values())
    bf16_step = 2.0 ** -7
    for name, (_, edges, counts) in pl.histograms.items():
        _, jedges, jcounts = jl.histograms[name]
        want_counts, want_edges = np.histogram(ptable[name], bins=20)
        assert np.array_equal(counts, want_counts)
        assert np.array_equal(edges, want_edges)
        span = float(np.max(np.abs(jedges.astype(np.float32))))
        assert np.max(np.abs(edges - jedges.astype(np.float64))) <= \
            bf16_step * span, name
        moved = np.abs(counts - jcounts).sum() / 2
        assert moved <= BF16_COUNT_SHARE * ptable[name].size, name
        assert counts.sum() == jcounts.sum() == ptable[name].size


def test_conv_grids_within_one_gray_level(tmp_path):
    jnet, pnet = _pair()
    probe = _data(n=8, seed=9)[0]
    pl = legacy.ConvolutionalIterationListener(
        probe, frequency=2, output_dir=str(tmp_path / "p"))
    jl = jlegacy.ConvolutionalIterationListener(
        probe, frequency=2, output_dir=str(tmp_path / "j"))
    pnet.set_listeners(pl)
    jnet.set_listeners(jl)
    for step in range(2):
        x, y = _data(seed=step)
        pnet.fit(DataSet(x, y))
        jnet.fit(JaxDataSet(x, y))
    assert [os.path.basename(p) for p in pl.written] == \
        [os.path.basename(p) for p in jl.written] == \
        ["conv_layer0_iter2.png", "conv_layer1_iter2.png",
         "conv_layer2_iter2.png"]
    acts = pnet.feed_forward(probe)
    for i, (a, b) in enumerate(zip(pl.written, jl.written)):
        got, want = _png_gray(a), _png_gray(b)
        assert got.shape == want.shape
        assert np.max(np.abs(got.astype(int) - want.astype(int))) <= 1
        # the PNG is the grid of a separate eager feed_forward
        assert np.array_equal(
            got, legacy.activation_grid(acts[i][0].numpy()))


# --------------------------------------------------------------- ui.main
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_ui_main_answers_the_same_routes(tmp_path, capsys):
    assert main.build_parser().parse_args([]).port == \
        jmain.build_parser().parse_args([]).port == 9000
    servers = {
        "jax": jmain.serve(["--port", "0", "--storage-file",
                            str(tmp_path / "j.db")], block=False),
        "port": main.serve(["--port", "0", "--storage-file",
                            str(tmp_path / "p.db")], block=False)}
    try:
        assert "UIServer listening at http://127.0.0.1:" in \
            capsys.readouterr().out
        routes = ["/", "/train/overview", "/train/sessions",
                  "/train/overview/data?sid=none", "/healthz", "/alerts",
                  "/no/such/route"]
        answers = {}
        for side, server in servers.items():
            base = f"http://127.0.0.1:{server.port}"
            answers[side] = []
            for route in routes:
                status, ctype, body = _get(base + route)
                keys = None
                if ctype and "json" in ctype:
                    parsed = json.loads(body)
                    keys = sorted(parsed) if isinstance(parsed, dict) \
                        else type(parsed).__name__
                answers[side].append((route, status, ctype, keys))
        assert answers["port"] == answers["jax"]
    finally:
        for server in servers.values():
            server.stop()


# ------------------------------------------------- the monitor's record
def test_system_metrics_persistable_round_trip():
    """Twin of ``tests/test_monitor.py``'s round trip, and the record's
    keys are the JAX record's."""
    monitor.reset()
    jmonitor.reset()
    jnet, pnet = _pair()
    x, y = _data()
    for _ in range(2):
        pnet.fit(DataSet(x, y))
        jnet.fit(JaxDataSet(x, y))
    storage, jstorage = InMemoryStatsStorage(), JaxInMemoryStatsStorage()
    monitor.post_system_metrics(storage, pnet, "sess_mon")
    jmonitor.post_system_metrics(jstorage, jnet, "sess_mon")
    rec = storage.get_latest_update("sess_mon", TYPE_ID, "monitor_0")
    jrec = jstorage.get_latest_update("sess_mon", TYPE_ID, "monitor_0")
    assert rec is not None and jrec is not None
    assert sorted(rec.data) == sorted(jrec.data)
    assert sorted(rec.data["monitor"]) == sorted(jrec.data["monitor"])
    assert sorted(rec.data["monitor"]["phases"]) == \
        sorted(jrec.data["monitor"]["phases"])
    assert (rec.type_id, rec.worker_id) == (jrec.type_id, jrec.worker_id)
    assert rec.data["iteration"] == pnet.iteration == 2
    assert rec.data["monitor"]["phases"]["steps"] >= 2
    assert "phase_step_ms" in rec.data["monitor"]["metrics"]
    np.testing.assert_allclose(rec.data["score"], jrec.data["score"],
                               rtol=SCORE_RTOL)

    server = UIServer(storage, port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        ov = json.loads(urllib.request.urlopen(
            base + "/train/overview/data?sid=sess_mon").read())
        assert len(ov["score_vs_iter"]) == 1
        assert ov["score_vs_iter"][0][0] == pnet.iteration
    finally:
        server.stop()

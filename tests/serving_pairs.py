"""Networks for the serving v2 and deployment parity tests: the same
configuration and weights in the JAX package and in the port (float32 on
the CPU, weights copied through the flat params vector), at small sizes.
"""

import numpy as np

from deeplearning4j_tpu.nn.conf import inputs as jin
from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers.attention import \
    CausalSelfAttention as JaxAttention
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

ATT_IN, ATT_T = 8, 16


def dense_conf(seed=7, n_in=4, hidden=16, n_out=3, dtype="float32"):
    return (JaxConf.builder().seed(seed).dtype(dtype)
            .updater("sgd").learning_rate(0.1).list()
            .layer(jcore.DenseLayer(n_out=hidden))
            .layer(jcore.OutputLayer(n_out=n_out))
            .set_input_type(jin.feed_forward(n_in)).build())


def cnn_conf(seed=7):
    return (JaxConf.builder().seed(seed).list()
            .layer(jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .layer(jconv.SubsamplingLayer(pooling_type="max"))
            .layer(jcore.DenseLayer(n_out=12))
            .layer(jcore.OutputLayer(n_out=5))
            .set_input_type(jin.convolutional(10, 10, 1)).build())


def lstm_conf(seed=7, dtype="float32", n_in=3, hidden=8, n_out=3):
    return (JaxConf.builder().seed(seed).dtype(dtype).list()
            .layer(jrec.GravesLSTM(n_out=hidden, activation="tanh"))
            .layer(jrec.RnnOutputLayer(n_out=n_out, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(jin.recurrent(n_in, 6)).build())


def attention_conf(seed=5, cache_len=32, dtype="float32"):
    return (JaxConf.builder().seed(seed).dtype(dtype).list()
            .layer(JaxAttention(n_out=16, n_heads=4, cache_len=cache_len))
            .layer(jrec.RnnOutputLayer(n_out=4, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(jin.recurrent(ATT_IN, ATT_T)).build())


CONFS = {"dense": dense_conf, "cnn": cnn_conf, "lstm": lstm_conf,
         "attention": attention_conf}


def port_net(conf):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()


def pair(conf):
    """``(jax_net, port_net)`` of one configuration on the same weights."""
    jnet = JaxNet(conf).init()
    pnet = port_net(conf)
    pnet.set_flat_params(np.asarray(jnet.get_flat_params()))
    return jnet, pnet


def inputs_for(kind, n, seed=0):
    rng = np.random.RandomState(seed)
    shape = {"dense": (n, 4), "cnn": (n, 10, 10, 1), "lstm": (n, 6, 3),
             "attention": (n, ATT_T, ATT_IN)}[kind]
    return rng.randn(*shape).astype(np.float32)


def host(tree):
    """A port tree's leaves as numpy (for comparisons)."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host(v) for v in tree)
    return tree.detach().cpu().numpy() if hasattr(tree, "detach") \
        else np.asarray(tree)


def compiles(monitor, name):
    """``serving_bucket_compiles_total`` of one engine."""
    total = 0.0
    snap = monitor.snapshot().get("serving_bucket_compiles_total", {})
    for labels, v in snap.get("values", {}).items():
        if f'engine="{name}"' in labels:
            total += v
    return total

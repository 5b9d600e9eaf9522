"""``updater_ms.lm`` on synthetic traces: the fused Adam kernel's name
lands in the ``updater`` class (``kernel_classes/updater.txt``) and no
other claims it; a trace whose updater runs as torch ops (the kernels
before the class existed) reads nothing; and the earlier cells' kernels
keep the classes they had."""

import pytest

from perfbench import run, trace
from perfbench.tests.test_perfbench_lm import ledger_kernel_names

READER = run.load_module(run.HERE / "metrics" / "updater_ms.lm.py",
                         "perfbench.metrics.updater_ms.lm")
#: the kernel's names as a profiler gives them, by template arguments
#: (gradient, storage param)
FUSED = [f"void (anonymous namespace)::adam_master_step_kernel<{g}, {p}>("
         f"{g} const*, float const*, float const*, float const*, float*, "
         f"float*, float*, {p}*, long long, (anonymous namespace)::"
         f"AdamScalars, double const*, float, int)"
         for g in ("__nv_bfloat16", "float") for p in ("__nv_bfloat16",
                                                        "float")]
#: the torch ops' kernels of the updater before the kernel (the ledger's
#: names for the LM cell)
OPS = ["void_at::native::vectorized_elementwise_kernel_4__at::native::CU",
       "void_at::native::_anonymous_namespace_::multi_tensor_apply_kerne",
       "void_at::native::unrolled_elementwise_kernel_at::native::direct_"]


def reading(device_events, steps=4):
    t = trace.summarize(device_events, [], 1.0, trace.kernel_classes())
    return READER.read({"trace": t, "readings": {"steps": steps}})


@pytest.mark.parametrize("name", FUSED)
def test_the_kernel_lands_in_the_updater_class(name):
    classes = trace.kernel_classes()
    assert trace.classify(name, classes) == "updater"
    # no class before it in name order (the first match wins) claims it
    earlier = {k: v for k, v in classes.items() if k < "updater"}
    assert trace.classify(name, earlier) == "other"


def test_the_reader_reads_ms_a_step_of_the_class():
    events = [(FUSED[0], 0.0, 30_000.0), (FUSED[1], 30_000.0, 32_000.0),
              (OPS[0], 32_000.0, 90_000.0)]
    assert reading(events) == pytest.approx(32.0 / 4)


def test_a_trace_of_the_torch_ops_updater_reads_nothing():
    events = [(n, 1000.0 * i, 1000.0 * (i + 1)) for i, n in enumerate(OPS)]
    assert reading(events) is None
    for n in ledger_kernel_names():
        assert trace.classify(n, trace.kernel_classes()) != "updater", n

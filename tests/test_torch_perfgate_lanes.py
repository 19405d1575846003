"""The port's perf-gate lanes run on the CPU beside the reference's same
lanes, in this process: their ``config`` blocks and their serving and
kvstore counters must be equal, their FLOPs close; and each port lane's
record lies within the committed host tier's bands
(``tests/perf_baseline_torch.json``), the check the CLI's child makes.

FLOPs: the reference's count is XLA's, which also counts the elementwise
work (LayerNorm, GELU, softmax, the cross entropy, Adam) that torch's
``FlopCounterMode`` leaves out; both count the same GEMMs and attention
products.  ``test_torch_costmodel.py`` measured 0.962 for a tiny BERT
step, so the port's count lies in [0.95, 1.0] of the reference's.
``llama_longseq`` is left out of that band: the port counts its causal
flash attention by the kernels' formula (half the square), the
reference's CPU path runs the dense causal attention, which XLA counts in
full.

The reference's lanes build their llama_tiny nets through
``_build_llama_tiny`` and its TrainStep lanes over ``make_mesh()``; here
the former takes the port's weights (numpy draws by name, so the tokens,
and with them the counters, can be compared) and the latter one device
(the pytest process has eight virtual devices; the reference's CLI pins
one per lane)."""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon.model_zoo import llama as jllama
from mxnet_tpu.telemetry import perfgate as jpg
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.telemetry import perfgate as tpg

FLOPS_BAND = (0.95, 1.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The lanes' ops are small: on a loaded host torch's intra-op
    threads cost far more than they save (the bert_seq512 lane: 42.8 s
    under six pytest workers on an 8-core host, 2.3 s alone)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _disarm(tel):
    tel.costmodel.disarm()
    tel.costmodel.LEDGER.clear()
    tel.tracer.disable()
    tel.clear()


@pytest.fixture
def reference(monkeypatch):
    """The reference's lanes, with the port's llama_tiny weights and one
    device for its TrainStep lanes."""
    import jax

    def build(seed):
        net = jllama.llama_model("llama_tiny", vocab_size=101, prefix="llm_")
        net.initialize(jmx.initializer.Zero())
        for name, w in tpg._llama_tiny_params(seed).items():
            net.collect_params()[name].set_data(jmx.nd.array(w))
        return net

    monkeypatch.setattr(jpg, "_build_llama_tiny", build)
    monkeypatch.setattr(jparallel, "make_mesh", lambda: jparallel.DeviceMesh(
        shape=(1,), devices=jax.devices()[:1]))
    yield jpg
    _disarm(jtel)


@pytest.fixture
def port():
    yield tpg
    _disarm(ttel)


def _within_host_tier(name, rec):
    base = tpg.load_baseline(tpg.default_baseline_path())["lanes"][name]
    fails = tpg.diff_lane(base, tpg.canonical_lanes({name: rec})[name])
    assert fails == [], fails


def _beside(name, ref_rec, rec, counters=True):
    assert rec["config"] == ref_rec["config"]
    if counters:
        assert rec["counters"] == ref_rec["counters"]
        assert rec["metrics"]["dispatches_per_step"] \
            == ref_rec["metrics"]["dispatches_per_step"]
    ratio = rec["metrics"]["flops"] / max(ref_rec["metrics"]["flops"], 1)
    if ref_rec["metrics"]["flops"] and rec["metrics"]["flops"]:
        print(f"\n{name}: FLOPs port {rec['metrics']['flops']} reference "
              f"{ref_rec['metrics']['flops']} ratio {ratio:.4f} "
              f"(band {FLOPS_BAND})")
        assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1]
    assert rec["metrics"]["retraces_steady"] == 0
    _within_host_tier(name, rec)


@pytest.mark.parametrize("name", ["trainer_fused_kvstore",
                                  "serving_continuous",
                                  "serving_spec_decode"])
def test_lane_beside_the_reference(reference, port, name):
    ref_rec = reference.run_lane(name)
    _disarm(jtel)
    rec = port.run_lane(name, device="cpu")
    _beside(name, ref_rec, rec)


@pytest.fixture(scope="module")
def reference_bert():
    """The reference's bert_headline record (its TrainStep compile is
    most of this module's time)."""
    import jax
    mp = pytest.MonkeyPatch()
    mp.setattr(jparallel, "make_mesh", lambda: jparallel.DeviceMesh(
        shape=(1,), devices=jax.devices()[:1]))
    try:
        yield jpg.run_lane("bert_headline")
    finally:
        mp.undo()
        _disarm(jtel)


def test_reference_bert_lane_is_its_committed_record(reference_bert):
    """The reference's lane, run here on one device, is the record its own
    gate holds it to (so the port is compared with the real thing)."""
    import os
    base = jpg.load_baseline(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "perf_baseline.json"))
    fails = jpg.diff_lane(base["lanes"]["bert_headline"],
                          jpg.canonical_lanes(
                              {"b": reference_bert})["b"])
    assert [f for f in fails if f["metric"] in
            ("config", "flops", "bytes_accessed", "retraces_steady",
             "dispatches_per_step")] == [], fails


def test_bert_lane_beside_the_reference(reference_bert, port):
    rec = port.run_lane("bert_headline", device="cpu")
    # the TrainStep counters differ by design: the reference's run() is
    # one dispatch of a scanned program, the port's one step a batch
    _beside("bert_headline", reference_bert, rec, counters=False)
    assert rec["counters"] == {"mxnet_sharding_retraces_total": 1,
                               "mxnet_sharding_step_dispatches_total": 8}

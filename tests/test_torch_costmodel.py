"""The port's cost ledger (``telemetry.costmodel``) held against the JAX
package's, on the CPU.

- Per-op entries: for ``dot``, ``batch_dot`` and ``FullyConnected``
  (no bias, 2-D data), the FLOPs and bytes accessed that the port counts
  (``FlopCounterMode`` and the byte-counting dispatch mode) equal the
  reference's XLA ``cost_analysis`` exactly: both count 2·m·n·k FLOPs
  and each operand read once plus the output written once.
- The flash kernels: counted by formula through their custom ops, so the
  plain twin that runs on the CPU gives the formula's count and its own
  matmuls are not added.
- A whole tiny BERT ``TrainStep``: its ``parallel.TrainStep`` entry equals
  the hand count of its GEMMs (forward, and backward twice the forward)
  plus the flash term, within 1 %; against the reference's XLA count of
  the same step the ratio stays in [0.93, 1.0] (see the test).
- Roofline, lane summary, the site table and the device table.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.telemetry import costmodel as jcm

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert, parallel, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.ops.nn import softmax_cross_entropy
from mxnet_tpu_torch.telemetry import costmodel as tcm


@pytest.fixture(autouse=True)
def _clean():
    """Both ledgers disarmed and empty around each test."""
    def reset():
        for cm in (jcm, tcm):
            cm.disarm()
            cm.LEDGER.clear()
    reset()
    yield
    reset()


# -- per-op entries -------------------------------------------------------------

def _op_cases(rs):
    a = rs.randn(64, 128).astype(np.float32)
    return {
        "dot": ("dot", [a, rs.randn(128, 32).astype(np.float32)], {}),
        "dot_transpose_b": ("dot", [a, rs.randn(32, 128).astype(np.float32)],
                            {"transpose_b": True}),
        "batch_dot": ("batch_dot", [rs.randn(4, 16, 8).astype(np.float32),
                                    rs.randn(4, 8, 12).astype(np.float32)],
                      {}),
        "fc_no_bias": ("FullyConnected",
                       [a, rs.randn(10, 128).astype(np.float32)],
                       {"num_hidden": 10, "no_bias": True}),
    }


def _entry(pkg, cm, name, arrays, attrs, ctx):
    cm.LEDGER.clear()
    cm.arm()
    try:
        getattr(pkg.nd, name)(*[pkg.nd.array(x, ctx=ctx) for x in arrays],
                              **attrs)
    finally:
        cm.disarm()
    ents = cm.LEDGER.entries(f"op:{name}")
    assert len(ents) == 1, cm.LEDGER.entries()
    return ents[0]


@pytest.mark.parametrize("case", ["dot", "dot_transpose_b", "batch_dot",
                                  "fc_no_bias"])
def test_op_entries_equal_reference_xla(case):
    name, arrays, attrs = _op_cases(np.random.RandomState(0))[case]
    j = _entry(jmx, jcm, name, arrays, attrs, jmx.cpu())
    t = _entry(tmx, tcm, name, arrays, attrs, tmx.cpu())
    assert (t["flops"], t["bytes_accessed"]) \
        == (j["flops"], j["bytes_accessed"])
    assert t["peak_bytes"] == 0 and t["compile_s"] == 0.0


def test_op_site_counts_calls_and_one_entry_a_signature():
    x = tmx.nd.array(np.ones((8, 8), np.float32), ctx=tmx.cpu())
    tcm.arm()
    for _ in range(3):
        tmx.nd.dot(x, x)
    tmx.nd.dot(tmx.nd.array(np.ones((4, 8), np.float32), ctx=tmx.cpu()), x)
    tcm.disarm()
    tmx.nd.dot(x, x)                    # disarmed: neither counted nor kept
    assert len(tcm.LEDGER.entries("op:dot")) == 2
    assert tcm.LEDGER.calls("op:dot") == 4
    summ = tcm.LEDGER.site_summary()["op:dot"]
    assert summ["executables"] == 2 and summ["flops"] == 2 * 8 * 8 * 8
    telemetry.clear()
    assert tcm.LEDGER.entries() == [] and tcm.LEDGER.calls("op:dot") == 0


# -- the flash kernels' FLOPs -----------------------------------------------------

@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_term_is_the_formula_with_the_twin(causal):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 256, 32, generator=g, requires_grad=True)
               for _ in range(3))

    def step(fn):
        def run():
            out = fn(q, k, v, causal=causal, sm_scale=0.125)
            out.sum().backward()
        return run

    _, counted = tcm.measure(step(fa.flash_attention))
    fwd = tcm.flash_flops(q.shape, k.shape, causal)
    assert fwd == 4 * 2 * 2 * 256 * 256 * 32 // (2 if causal else 1)
    assert counted["flops"] == fwd + tcm.flash_flops(q.shape, k.shape,
                                                     causal, backward=True)
    # the twin called directly is counted op by op: its matmuls (with the
    # backward's recompute of p) are what the custom op keeps out
    _, plain = tcm.measure(step(fa.flash_attention_plain))
    assert plain["flops"] > counted["flops"]
    # bytes: q, k, v, o, lse forward and q, k, v, o, lse, dO, dq, dk, dv
    # backward are all in the count
    elt = q.numel() * 4
    lse = 2 * 2 * 256 * 4
    assert counted["bytes_accessed"] >= 4 * elt + lse + 8 * elt + lse


# -- a whole step ---------------------------------------------------------------

L, B, VOCAB = 256, 2, 97
NAME = "bert_3_128_2"


@pytest.fixture(scope="module")
def tiny_bert():
    """The JAX BERT and the port's on the same weights, and one batch."""
    net = jbert.bert_model(NAME, vocab_size=VOCAB, max_length=L,
                           dropout=0.0, prefix="bert_")
    net.initialize(jmx.initializer.Zero())
    r = np.random.RandomState(3)
    params = {}
    for k, p in net.collect_params().items():
        w = r.normal(0.0, 0.02, p.shape).astype(np.float32)
        if k.endswith(("bias", "beta")):
            w[...] = 0.0
        elif k.endswith("gamma"):
            w[...] = 1.0
        p.set_data(jmx.nd.array(w))
        params[k] = w
    port = convert.bert_from_gluon(params, "bert_", NAME, device="cpu")
    toks = r.randint(0, VOCAB, (B, L)).astype(np.int32)
    labels = r.randint(0, VOCAB, (B, L)).astype(np.int32)
    return {"net": net, "port": port, "toks": toks, "labels": labels}


@pytest.fixture(scope="module")
def port_entry(tiny_bert):
    """Two armed calls of the port's TrainStep: its ledger entry, calls
    and lane summary (one run shared by the tests below)."""
    step = parallel.TrainStep(tiny_bert["port"], _torch_loss, "adam",
                              optimizer_params={"learning_rate": 1e-3})
    tcm.LEDGER.clear()
    tcm.arm()
    try:
        for _ in range(2):
            step(torch.tensor(tiny_bert["toks"]),
                 torch.tensor(tiny_bert["labels"]))
        return {"entries": tcm.LEDGER.entries("parallel.TrainStep"),
                "calls": tcm.LEDGER.calls("parallel.TrainStep"),
                "lane": tcm.lane_summary(step_seconds=0.5, dtype="float32"),
                "report": telemetry.report(cost=True)}
    finally:
        tcm.disarm()
        tcm.LEDGER.clear()


def _torch_loss(out, labels):
    logits = out[2]
    return softmax_cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(),
        labels.reshape(-1)) / labels.numel()


def _jax_loss(out, labels):
    logits = out[2]
    return jmx.nd.softmax_cross_entropy(
        logits.reshape((-1, logits.shape[-1])).astype("float32"),
        labels.reshape((-1,))) / labels.size


def hand_count(layers, units, hidden, vocab, batch, seq):
    """A BERT training step's FLOPs counted by hand: each Dense's GEMM
    2·T·in·out forward and twice that backward; the pooler forward only
    (the loss does not read it); attention 4·B·L²·U forward and twice that
    backward a layer."""
    T = batch * seq
    per_layer = 2 * T * (3 * units * units + units * units
                         + 2 * units * hidden)
    gemm = 3 * (layers * per_layer + 2 * T * units * vocab)
    pooler = 2 * batch * units * units
    attention = 12 * layers * batch * seq * seq * units
    return gemm + pooler + attention


def test_tiny_bert_trainstep_entry_equals_hand_count(port_entry):
    ents = port_entry["entries"]
    assert len(ents) == 1
    want = hand_count(3, 128, 512, VOCAB, B, L)
    assert ents[0]["flops"] == pytest.approx(want, rel=0.01)
    assert ents[0]["bytes_accessed"] > 0 and ents[0]["compile_s"] == 0.0
    assert port_entry["calls"] == 2
    lane = port_entry["lane"]
    assert lane["flops"] == ents[0]["flops"] and lane["executables"] == 1
    assert lane["analytic_mfu"] == pytest.approx(
        ents[0]["flops"] / (0.5 * tcm.peak_flops("float32")), abs=1e-4)
    assert "cost ledger (1 site(s), 1 executable(s))" in port_entry["report"]
    assert "parallel.TrainStep" in port_entry["report"]


def test_tiny_bert_count_beside_the_reference(tiny_bert, port_entry,
                                              monkeypatch, capsys):
    """The reference's XLA count of the same step is larger: XLA's HLO cost
    model also counts elementwise work (LayerNorm, GELU, the dense
    attention's softmax on the reference's CPU path, the cross entropy,
    Adam's update) that ``FlopCounterMode`` leaves out, while both count
    the same GEMMs and attention products.  That work is a few percent of
    a step at these widths (0.962 measured), so the port's count lies in
    [0.93, 1.0] of the reference's."""
    import jax
    monkeypatch.setenv("MXNET_COSTMODEL_MEMORY", "0")   # no 2nd compile
    jcm.arm()
    mesh = jparallel.DeviceMesh(shape=(1,), devices=jax.devices()[:1])
    jstep = jparallel.TrainStep(tiny_bert["net"], _jax_loss,
                                jmx.optimizer.Adam(learning_rate=1e-3),
                                mesh=mesh)
    jstep(jmx.nd.array(tiny_bert["toks"], dtype="int32"),
          jmx.nd.array(tiny_bert["labels"], dtype="int32"))
    ref = jcm.LEDGER.entries("parallel.TrainStep")[0]["flops"]
    ours = port_entry["entries"][0]["flops"]
    with capsys.disabled():
        print(f"\ntiny BERT step FLOPs: reference (XLA) {ref:.0f}, "
              f"port {ours:.0f}, ratio {ours / ref:.4f}")
    assert 0.93 <= ours / ref <= 1.0


# -- roofline, summaries, device table ---------------------------------------------

@pytest.fixture
def peaks(monkeypatch):
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("MXNET_PEAK_HBM_GBS", "100")


@pytest.mark.parametrize("args", [
    (2e9, 1e9, 0.01, "bfloat16"), (2e10, 1e9, None, "float32"),
    (123456.0, 0.0, 3e-3, "bfloat16"), (5e12, 2.5e9, 7.25, "float32")])
def test_roofline_equals_reference(peaks, args):  # noqa: ARG001
    flops, byts, secs, dtype = args
    assert tcm.roofline(flops, byts, secs, dtype) \
        == jcm.roofline(flops, byts, secs, dtype)


def _entries():
    return [
        {"site": "parallel.TrainStep", "compile_s": 1.5, "time": 0.0,
         "flops": 4e9, "bytes_accessed": 1e9, "peak_bytes": 3 << 20,
         "index": 0},
        {"site": "parallel.TrainStep", "compile_s": 0.25, "time": 0.0,
         "flops": 8e9, "bytes_accessed": 3e9, "peak_bytes": 5 << 20,
         "index": 1},
        {"site": "op:dot", "compile_s": 0.0, "time": 0.0, "flops": 512.0,
         "bytes_accessed": 768.0, "peak_bytes": 0, "index": 0},
        {"site": "op:bad", "compile_s": 0.0, "time": 0.0,
         "error": "RuntimeError: x", "index": 0},
    ]


def test_lane_summary_and_site_table_equal_reference(peaks):  # noqa: ARG001
    for cm in (jcm, tcm):
        cm.LEDGER._entries.extend(_entries())
    for secs in (None, 0.02):
        for dtype in ("bfloat16", "float32"):
            assert tcm.lane_summary(step_seconds=secs, dtype=dtype) \
                == jcm.lane_summary(step_seconds=secs, dtype=dtype)
    assert tcm.lane_summary("none") == jcm.lane_summary("none")
    assert tcm.summarize_entries(_entries(), {"op:dot": 3}) \
        == jcm.summarize_entries(_entries(), {"op:dot": 3})
    assert tcm.report_text() == jcm.report_text()
    assert tcm.site_table_lines(tcm.LEDGER.site_summary()) \
        == jcm.site_table_lines(jcm.LEDGER.site_summary())


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989.4e12, 66.9e12, 3.35e12)),
    ("NVIDIA H100 SXM5 80GB", (989.4e12, 66.9e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 51.2e12, 2.0e12)),
])
def test_device_table(monkeypatch, name, want):
    monkeypatch.setattr(tcm, "_device_kind", lambda: (name, False))
    assert (tcm.peak_flops("bfloat16"), tcm.peak_flops(torch.float16),
            tcm.peak_flops("float32"), tcm.peak_hbm_bytes_per_s()) \
        == (want[0], want[0], want[1], want[2])
    # the f32 peak is the card's own, not the reference's bf16/4
    assert tcm.peak_flops("float32") != tcm.peak_flops("bfloat16") / 4
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "7e14")
    monkeypatch.setenv("MXNET_PEAK_HBM_GBS", "1500")
    assert tcm.peak_flops("float32") == 7e14
    assert tcm.peak_hbm_bytes_per_s() == 1.5e12


def test_unknown_card_raises_and_cpu_is_nominal(monkeypatch):
    assert (tcm.peak_flops(), tcm.peak_hbm_bytes_per_s()) == (5e11, 5e10)
    assert tcm.peak_flops("float32") == jcm.peak_flops("float32")
    monkeypatch.setattr(tcm, "_device_kind",
                        lambda: ("NVIDIA A100-SXM4-80GB", False))
    for fn in (tcm.peak_flops, tcm.peak_hbm_bytes_per_s):
        with pytest.raises(MXNetError,
                           match="MXNET_PEAK_FLOPS.*MXNET_PEAK_HBM_GBS"):
            fn()
    # the estimator is the reference's (tests/test_torch_autoshard.py)
    assert tcm.estimate_memory({"w": (4, 4)}, {"dp": 1}, None, batch=1) \
        == jcm.estimate_memory({"w": (4, 4)}, {"dp": 1}, None, batch=1)


def test_wrapped_site_and_late_arming():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return (x @ x) * scale

    w = tcm.wrap(fn, "t.site")
    x = torch.ones(4, 4)
    w(x)                                  # disarmed: nothing recorded
    assert tcm.LEDGER.entries("t.site") == [] \
        and tcm.LEDGER.calls("t.site") == 0
    tcm.arm()
    for _ in range(3):
        w(x, scale=2.0)
    w(torch.ones(2, 2))
    assert [e["flops"] for e in tcm.LEDGER.entries("t.site")] \
        == [2 * 4 ** 3, 2 * 2 ** 3]
    assert tcm.LEDGER.calls("t.site") == 4 and len(calls) == 5
    snap = tcm.LEDGER.snapshot()
    assert snap["calls"]["t.site"] == 4 and len(snap["entries"]) == 2

"""chip_smoke.read_trace (profile_step's reading of a trace's raw kineto
events) against chip_smoke.parts_by_function_events (the same reading
from torch's own FunctionEvent tree, what profile_step read before), on
fixed event trees that need no card: the parts label for label and ms for
ms, the device's spans and the host's ms in K2's backward nodes.

The trees go through torch's own parsing (chip_smoke.function_events:
``torch.autograd.profiler.profile._parse_kineto_results`` and
``EventList._build_tree``), from stand-ins of the kineto events that
carry what the profiler records on the card: CPU operations on their
threads, CUDA runtime calls on a thread of their own, linked to the operation
that made them, and kernels linked the same way.  Both readings sum in
the same order, so they agree to the bit.
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

T0 = 1_000_000_000          # the trace's start, ns
RUNTIME_THREAD = 77         # the thread CUPTI reports a runtime call on
LSTM_BWD = "autograd::engine::evaluate_function: LstmCellBackward"
K2_BWD = "void lstm_cell_wgmma<true, false>(Params)"


class Event:
    """A stand-in of torch's _KinetoEvent: what the parsers read."""

    _LISTS = ("shapes", "stack", "concrete_inputs", "dtypes",
              "structured_input_shapes", "structured_input_strides")

    def __init__(self, name, device, start_us, end_us, thread=1, corr=0,
                 linked=0, end_thread=None, user_annotation=False,
                 is_async=False):
        self._v = dict(
            name=name, device_type=device, start_ns=T0 + 1000 * start_us,
            end_ns=T0 + 1000 * end_us, duration_ns=1000 * (end_us - start_us),
            start_thread_id=thread,
            end_thread_id=thread if end_thread is None else end_thread,
            correlation_id=corr, linked_correlation_id=linked,
            is_user_annotation=user_annotation, is_async=is_async,
            fwd_thread_id=thread, kwinputs={}, overload_name="",
            device_index=0, cuda_elapsed_us=0, extra_meta=None)

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        v = self.__dict__["_v"]
        if attr in v:
            return lambda: v[attr]
        return lambda: [] if attr in self._LISTS else 0


class Result:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def trace_start_ns(self):
        return T0


class Tree:
    """Builds a trace: ``op`` a CPU operation, ``launch`` a kernel made by
    an operation (its runtime call on RUNTIME_THREAD, linked)."""

    def __init__(self):
        self.events, self.corr = [], 0

    def op(self, name, start, end, thread=1, **kw):
        self.corr += 1
        self.events.append(Event(name, DeviceType.CPU, start, end, thread,
                                 corr=self.corr, **kw))
        return self.corr

    def launch(self, corr, kernel, at, start, dur):
        self.events.append(Event("cudaLaunchKernel", DeviceType.CPU, at,
                                 at + 1, RUNTIME_THREAD, corr=0,
                                 linked=corr))
        self.events.append(Event(kernel, DeviceType.CUDA, start,
                                 start + dur, thread=7, linked=corr))

    def annotation(self, name, start, end):
        """a record_function range placed on the device's timeline"""
        self.events.append(Event(name, DeviceType.CUDA, start, end,
                                 thread=7, user_annotation=True))


def readings(events, ranges):
    """-> (read_trace's reading, the FunctionEvent tree's), each as
    (parts, spans, the host's ms in K2's backward nodes)."""
    result = Result(events)
    new = cs.read_trace(torch, result, ranges)
    tree = cs.function_events(torch, result)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in tree
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.name not in ranges)
    k2_host = sum(e.cpu_time_total for e in tree
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith(LSTM_BWD)) / 1e3
    return ((new["parts"], new["spans"], new["k2_host_ms"]),
            (cs.parts_by_function_events(torch, tree, ranges), spans,
             k2_host))


def xe_step_tree():
    """An XE step's shapes: a kernel under a range, K2's backward (its
    three kernels and one extra product, autograd's sum of its outputs),
    cuDNN's backward, another backward node, and launches with no parent
    and with no operation at all."""
    t = Tree()
    t.op("xe:teacher_forcing", 0, 100, user_annotation=True)
    t.annotation("xe:teacher_forcing", 5, 90)
    mm = t.op("aten::mm", 10, 20)
    t.launch(mm, "ampere_sgemm_128x64_tn", 11, 30, 7)
    cell = t.op("LstmCellForward", 30, 40)
    t.launch(cell, "void lstm_cell_wgmma<false, false>(Params)", 31, 40, 5)
    # autograd's thread: K2's backward node
    t.op(LSTM_BWD, 200, 300, thread=2)
    node = t.op("LstmCellBackward", 201, 299, thread=2)
    t.launch(node, K2_BWD, 205, 310, 4)
    t.launch(node, "void lstm_bwd_dxh_wgmma<1>(Params)", 206, 315, 6)
    t.launch(node, "void lstm_bwd_dw_wgmma<1>(Params)", 207, 322, 8)
    extra = t.op("aten::mm", 210, 220, thread=2)
    t.launch(extra, "ampere_sgemm_64x64_nn", 211, 331, 3)
    add = t.op("aten::add", 230, 240, thread=2)
    t.launch(add, "elementwise_kernel_add", 231, 335, 2)
    copy = t.op("aten::copy_", 250, 260, thread=2)
    t.launch(copy, "elementwise_kernel_copy", 251, 338, 1)
    # cuDNN's backward through layer4
    t.op("autograd::engine::evaluate_function: ConvolutionBackward0", 400,
         500, thread=2)
    t.op("ConvolutionBackward0", 401, 499, thread=2)
    conv = t.op("aten::convolution_backward", 402, 498, thread=2)
    t.launch(conv, "cudnn::bn_bw_1C11_kernel_new", 410, 510, 9)
    t.launch(conv, "sm90_xmma_dgrad_f32f32", 411, 520, 12)
    # another backward node
    t.op("autograd::engine::evaluate_function: AddmmBackward0", 600, 650,
         thread=2)
    other = t.op("aten::mm", 610, 620, thread=2)
    t.launch(other, "ampere_sgemm_32x32_nt", 611, 660, 2)
    # no parent, and a copy that no operation made
    top = t.op("aten::add_", 700, 710)
    t.launch(top, "elementwise_kernel_add_", 701, 720, 3)
    t.events.append(Event("Memcpy HtoD (Pageable -> Device)",
                          DeviceType.CUDA, 730, 735, thread=7))
    return t.events


def test_an_xe_step_reads_alike_label_for_label():
    (parts, spans, k2), (want, want_spans, want_k2) = readings(
        xe_step_tree(), cs.XE_RANGES)
    assert parts == want
    assert spans == want_spans and len(spans) == 13
    assert k2 == want_k2 == 0.1
    assert parts == pytest.approx({
        "xe:teacher_forcing": 0.007, "K2 forward kernel": 0.005,
        "K2 backward kernel": 0.004, "K2 backward's product kernels": 0.014,
        cs.K2_PRODUCTS_PART: 0.003,
        "autograd's sums of K2 backward's outputs": 0.002,
        "K2 backward's cotangent copies": 0.001,
        cs.TRUNK_BWD_PART: 0.021, "backward, other": 0.002, "other": 0.003},
        rel=1e-12)


@pytest.mark.parametrize("case", ["range", "lstm_backward",
                                  "convolution_backward", "no_parent"])
def test_each_part_reads_alike_alone(case):
    """Each of the tree's parts in a trace of its own."""
    t = Tree()
    if case == "range":
        t.op("scst:rollout", 0, 100, user_annotation=True)
        op = t.op("aten::gather", 10, 20)
        t.launch(op, "gather_kernel", 11, 40, 6)
    elif case == "lstm_backward":
        t.op(LSTM_BWD, 0, 100, thread=2)
        node = t.op("LstmCellBackward", 1, 99, thread=2)
        for i, k in enumerate((K2_BWD, "lstm_bwd_dxh_tf32x3",
                               "lstm_bwd_dw_tf32x3")):
            t.launch(node, k, 2 + i, 120 + 10 * i, 4 + i)
        mm = t.op("aten::matmul", 50, 60, thread=2)
        t.launch(mm, "cutlass_gemm", 51, 160, 5)
    elif case == "convolution_backward":
        t.op("autograd::engine::evaluate_function: ConvolutionBackward0",
             0, 100, thread=2)
        op = t.op("aten::cudnn_convolution_backward_weight", 5, 95,
                  thread=2)
        t.launch(op, "sm90_xmma_wgrad", 6, 130, 11)
    else:
        op = t.op("aten::fill_", 0, 10)
        t.launch(op, "fill_kernel", 1, 20, 2)
    (parts, spans, k2), want = readings(t.events, cs.SCST_RANGES)
    assert (parts, spans, k2) == want and parts


def test_a_runtime_call_nests_under_its_operation():
    """A runtime call inside an operation's interval, reported on another
    thread, takes the operation's thread (and never parents it)."""
    t = Tree()
    t.op("xe:loss", 0, 100, user_annotation=True)
    op = t.op("aten::log_softmax", 10, 50)
    inner = t.op("aten::_log_softmax", 11, 49)
    t.launch(inner, "softmax_warp_forward", 12, 60, 5)
    t.launch(op, "reduce_kernel", 13, 70, 2)
    got, want = readings(t.events, cs.XE_RANGES)
    assert got == want and got[0] == {"xe:loss": 0.007}


def test_a_deep_real_trace_reads_alike():
    """The CPU operations of a real autograd step on this host (two ranges
    around a forward, a backward through linear layers, a ReLU and an
    LSTM cell), with a kernel linked to every third operation that
    encloses none of its own name (one that does torch may fold, as
    :func:`test_a_folded_operation_keeps_its_kernels` shows), leaves and
    enclosing ones: every nesting torch's tree builds, read alike."""
    from torch.profiler import ProfilerActivity, profile, record_function
    g = torch.Generator().manual_seed(0)
    lin = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                              torch.nn.Linear(32, 16))
    cell = torch.nn.LSTMCell(16, 16)
    x = torch.randn(8, 16, generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("xe:encode"):
            h = lin(x)
        with record_function("xe:teacher_forcing"):
            hc = (h, torch.zeros_like(h))
            for _ in range(3):
                hc = cell(x, hc)
        hc[0].square().mean().backward()
    real = list(prof.profiler.kineto_results.events())
    t0 = prof.profiler.kineto_results.trace_start_ns()
    cpu = [(ev.start_thread_id(), ev.start_ns(), ev.end_ns(), ev.name())
           for ev in real if ev.device_type() == DeviceType.CPU]

    def encloses(ev):
        th, s, e = ev.start_thread_id(), ev.start_ns(), ev.end_ns()
        return any(t == th and s <= a and b <= e and (a, b) != (s, e)
                   and n == ev.name() for t, a, b, n in cpu)

    events, n, inner = [], 0, 0
    for i, ev in enumerate(real):
        events.append(ev)
        if (ev.device_type() == DeviceType.CPU and ev.correlation_id() > 0
                and i % 3 == 0 and not encloses(ev)):
            n += 1
            inner += any(t == ev.start_thread_id() and ev.start_ns() <= a
                         and b <= ev.end_ns() and (a, b) != (
                             ev.start_ns(), ev.end_ns())
                         for t, a, b, _ in cpu)
            start = (ev.start_ns() - T0) // 1000 + 1
            events.append(Event("kernel_%d" % (i % 7), DeviceType.CUDA,
                                start, start + 1 + i % 5, thread=7,
                                linked=ev.correlation_id()))
    assert n > 20 and inner > 5 and t0 > 0

    class Shifted(Result):
        def trace_start_ns(self):
            return t0

    result = Shifted(events)
    new = cs.read_trace(torch, result, cs.XE_RANGES)
    want = cs.parts_by_function_events(
        torch, cs.function_events(torch, result), cs.XE_RANGES)
    assert new["parts"].keys() == want.keys()
    for k in want:
        assert new["parts"][k] == pytest.approx(want[k], rel=1e-12, abs=0)
    assert {"xe:encode", "xe:teacher_forcing",
            "backward, other"} <= set(want)


def test_a_folded_operation_keeps_its_kernels():
    """Where an operation's only child has its name, torch's tree folds
    the child into it and keeps the child's kernels alone
    (EventList._remove_dup_nodes); read_trace counts both, so the parent's
    own kernel moves out of "unattributed" into its part."""
    t = Tree()
    t.op("xe:optimizer", 0, 100, user_annotation=True)
    outer = t.op("aten::copy_", 10, 50)
    inner = t.op("aten::copy_", 11, 49)
    t.launch(outer, "copy_outer", 12, 60, 3)
    t.launch(inner, "copy_inner", 13, 70, 2)
    (parts, spans, _), (want, want_spans, _) = readings(t.events,
                                                        cs.XE_RANGES)
    assert spans == want_spans
    assert want == {"xe:optimizer": 0.002}
    assert parts == {"xe:optimizer": 0.005}

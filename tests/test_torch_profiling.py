"""``scaleprotoseg_torch/profiling.py`` and ``train.profile_steps``.

The per-kernel table on a hand-written Chrome trace (exact sums,
categories, the ``--steps-from`` drop, the ``TOTAL`` fields and the idle
share), the trainer CLI on the CPU writing a trace of
``train.profile_steps`` micro-steps that the table reads back (the
counterpart of ``tests/test_e2e_train.py``'s profiled run), the
``StepProfiler`` window, and ``time_fn`` / ``flops_estimate`` against
the JAX package's.
"""

import contextlib
import gzip
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scaleprotoseg_tpu import profiling as jprofiling
from scaleprotoseg_torch import profiling
from scaleprotoseg_torch import train_wandb_multiscale as trainer
from scaleprotoseg_torch.configlib import parse_config
from scaleprotoseg_torch.models.deeplab import DeepLabV2
from scaleprotoseg_torch.models.ppnet import PPNet
from scaleprotoseg_torch.spec import ProtoSpec
from scaleprotoseg_torch.train.runner import PhaseTrainer, module_hparams
from e2e_utils import build_synthetic_dataset
from test_torch_train_step import TINY
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

SPAN = profiling.STEP_SPAN


def _x(name, cat, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _gpu_trace():
    """Three micro-steps (spans at 1000, 1200, 1400 us, 100 us each);
    each device event carries the correlation id of the runtime call that
    launched it; one kernel is launched between the steps."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0,
           "args": {"name": "GPU 0"}}]
    ev += [_x(SPAN, "user_annotation", t, 100) for t in (1000, 1200, 1400)]
    ev += [_x(SPAN, "gpu_user_annotation", t + 5, 90, pid=0, tid=7)
           for t in (1000, 1200, 1400)]
    launches = {1: 1010, 2: 1020, 3: 1210, 4: 1220, 5: 1230, 6: 1410,
                7: 1420, 8: 1350}
    ev += [_x("cudaLaunchKernel", "cuda_runtime", t, 3, correlation=c)
           for c, t in launches.items()]
    dev = dict(pid=0, tid=7)
    ev += [_x("void aspp_kernel<2>(CUtensorMap_st)", "kernel", 1030, 20,
              correlation=1, **dev),
           _x("sm90_xmma_gemm_bf16bf16_bf16f32", "kernel", 1060, 10,
              correlation=2, **dev),
           _x("void aspp_kernel<2>(CUtensorMap_st)", "kernel", 1240, 20,
              correlation=3, **dev),
           _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1265, 5,
              correlation=4, **dev),
           # launched in step 2, ends after its span, overlaps the copy
           _x("void at::native::vectorized_elementwise_kernel<4>", "kernel",
              1268, 40, correlation=5, **dev),
           _x("void aspp_kernel<2>(CUtensorMap_st)", "kernel", 1430, 20,
              correlation=6, **dev),
           _x("Memset (Device)", "gpu_memset", 1450, 2, correlation=7,
              **dev),
           # launched between the steps: in no step
           _x("void stray_kernel", "kernel", 1360, 10, correlation=8, **dev)]
    return {"traceEvents": ev}


def _write(tmp_path, d, name="h_1.1" + profiling.TRACE_SUFFIX):
    tmp_path.mkdir(parents=True, exist_ok=True)
    with gzip.open(tmp_path / name, "wt") as f:
        json.dump(d, f)
    return str(tmp_path)


def _cli(capsys, *argv):
    profiling.main(list(argv))
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_table_on_a_handwritten_trace(tmp_path, capsys):
    trace_dir = _write(tmp_path / "prof", _gpu_trace())
    lines = _cli(capsys, trace_dir, "--steps-from", "0")
    ops = {r["op"]: r for r in lines if not r["op"].startswith(("CATEGORY",
                                                               "TOTAL"))}
    aspp = ops["void aspp_kernel<2>(CUtensorMap_st)"]
    assert (aspp["category"], aspp["count"]) == ("aspp_kernel", 3)
    assert aspp["ms_total"] == pytest.approx(0.060)
    assert aspp["ms_per_step"] == pytest.approx(0.020)
    assert aspp["pct"] == pytest.approx(round(100 * 60 / 117, 2))
    assert ops["sm90_xmma_gemm_bf16bf16_bf16f32"]["category"] == "conv"
    assert ops["void at::native::vectorized_elementwise_kernel<4>"][
        "category"] == "elementwise"
    assert "void stray_kernel" not in ops
    assert [r["op"] for r in lines[:2]] == [
        "void aspp_kernel<2>(CUtensorMap_st)",
        "void at::native::vectorized_elementwise_kernel<4>"]
    cats = {r["op"]: r for r in lines if r["op"].startswith("CATEGORY:")}
    assert {k: (v["ms_total"], v["count"]) for k, v in cats.items()} == {
        "CATEGORY:aspp_kernel": (0.06, 3), "CATEGORY:elementwise": (0.04, 1),
        "CATEGORY:conv": (0.01, 1), "CATEGORY:other": (0.007, 2)}
    total = lines[-1]
    assert total == {"op": "TOTAL", "timeline": "device",
                     "n_steps_traced": 3, "device_ms_per_step": 0.039,
                     "wall_ms_per_step": round(0.5 / 3, 4),
                     "idle_share": round(1 - 115 / 500, 4)}

    # the first step dropped; the rollup alone
    lines = _cli(capsys, trace_dir, "--steps-from", "1", "--by-category")
    assert all(r["op"].startswith(("CATEGORY:", "TOTAL")) for r in lines)
    assert {r["op"]: r["ms_total"] for r in lines[:-1]} == {
        "CATEGORY:aspp_kernel": 0.04, "CATEGORY:elementwise": 0.04,
        "CATEGORY:other": 0.007}
    assert lines[-1] == {"op": "TOTAL", "timeline": "device",
                         "n_steps_traced": 2, "device_ms_per_step": 0.0435,
                         "wall_ms_per_step": 0.15,
                         "idle_share": round(1 - 85 / 300, 4)}
    # the default drops one step, as the JAX tool does; --top cuts the ops
    lines = _cli(capsys, trace_dir, "--top", "1")
    assert lines[0]["op"] == "void aspp_kernel<2>(CUtensorMap_st)"
    assert lines[1]["op"].startswith("CATEGORY:")
    assert lines[-1]["n_steps_traced"] == 2


def test_table_of_a_cpu_trace_reads_the_outermost_operators(tmp_path):
    """No device event: the step thread's outermost CPU operators, and
    the TOTAL says it read the CPU."""
    ev = [_x(SPAN, "user_annotation", 0, 100),
          _x("aten::conv2d", "cpu_op", 10, 40),
          _x("aten::convolution", "cpu_op", 12, 30),     # inside conv2d
          _x("aten::add", "cpu_op", 60, 10),
          _x("aten::copy_", "cpu_op", 20, 50, tid=2)]    # a loader thread
    groups, s = profiling.aggregate({"traceEvents": ev}, steps_from=0)
    assert {k: (g["us"], g["count"], g["category"])
            for k, g in groups.items()} == {
        "aten::conv2d": (40.0, 1, "conv"), "aten::add": (10.0, 1, "other")}
    total = profiling.table_lines({"traceEvents": ev}, steps_from=0)[-1]
    assert total == {"op": "TOTAL", "timeline": "cpu", "n_steps_traced": 1,
                     "cpu_op_ms_per_step": 0.05, "wall_ms_per_step": 0.1,
                     "cpu_idle_share": 0.5}
    with pytest.raises(FileNotFoundError):
        profiling.load_trace(str(tmp_path))


def test_kernel_groups():
    g = profiling.kernel_group
    assert g("void aspp_grad_pack_kernel<64>", profiling.TRAINING_GROUPS) \
        == "aspp_grad_pack_kernel"
    assert g("void aspp_kernel<2>", profiling.TRAINING_GROUPS) == \
        "aspp_kernel"
    assert g("cudnn_batch_norm_forward_inference", profiling.SERVING_GROUPS) \
        == "batch_norm"
    assert g("nvjet_tst_128x256_64x4", profiling.SERVING_GROUPS) == "conv"
    assert g("void int8_conv3x3_kernel<1>", profiling.QUANT_GROUPS) == \
        "int8_conv3x3_kernel"
    assert g("void at::native::multi_tensor_apply_kernel<FusedAdam>",
             profiling.TRAINING_GROUPS) == "adam"
    assert g("Memcpy DtoH (Device -> Pinned)") == "other"


def _run_profiled_cli(tmp_path, joint_steps, profile_steps):
    root = build_synthetic_dataset(str(tmp_path / "data"), n_train=4,
                                   n_val=2, size=48)
    argv = ["scaleproto_cityscapes", "prof_run", "--device", "cpu",
            "--data-root", root, "--results-root", str(tmp_path / "res")]
    for line in TINY + ["train.warmup_steps = 0",
                        f"train.joint_steps = {joint_steps}",
                        "train.push_proto = False",
                        f"train.profile_steps = {profile_steps}"]:
        argv += ["--gin", line]
    out = trainer.main(argv)
    run = tmp_path / "res" / "prof_run"
    return out, run, (run / "train.log").read_text()


def test_profile_steps_through_the_trainer_cli(tmp_path):
    out, run, log = _run_profiled_cli(tmp_path, 5, 2)
    assert out["phases"][1].steps_done == 5
    names = os.listdir(run / "profile")
    assert len(names) == 1 and names[0].endswith(profiling.TRACE_SUFFIX)
    assert f"profiling steps 4..5 -> {run / 'profile'}" in log
    assert "profiler trace written" in log
    assert "fast_gradconv=False remat=False" in log
    lines = profiling.table_lines(profiling.load_trace(str(run / "profile")),
                                  steps_from=0)
    total = lines[-1]
    assert total["n_steps_traced"] == 2 and total["timeline"] == "cpu"
    assert total["cpu_op_ms_per_step"] > 0
    assert any(r["op"] == "CATEGORY:conv" for r in lines)


def test_step_profiler_window(tmp_path):
    """Starts WARMUP_STEPS into a phase (from its restored step), spans
    only the window, writes one trace, and traces once per trainer; an
    interrupted window writes nothing; a phase ending mid-window ends
    the trace."""
    def run(prof, steps0, n, stop_at_end=True):
        for s in range(steps0, steps0 + n):
            prof.begin(s, steps0)
            span = prof.span()
            assert isinstance(span, contextlib.nullcontext) != prof.active
            with span:
                torch.ones(8).sum()
            if prof.due(s + 1):
                prof.stop()
        if stop_at_end:
            prof.stop()

    logs = []
    prof = profiling.StepProfiler(3, str(tmp_path / "a"),
                                  torch.device("cpu"), logs.append)
    run(prof, 10, 8)
    assert logs[0] == f"profiling steps 14..16 -> {tmp_path / 'a'}"
    (name,) = os.listdir(tmp_path / "a")
    d = profiling.load_trace(str(tmp_path / "a" / name))
    assert profiling.table_lines(d, steps_from=0)[-1]["n_steps_traced"] == 3
    run(prof, 0, 8)                     # the next phase: no second trace
    assert len(os.listdir(tmp_path / "a")) == 1

    prof = profiling.StepProfiler(3, str(tmp_path / "b"),
                                  torch.device("cpu"), logs.append)
    run(prof, 0, 5, stop_at_end=False)
    assert prof.active
    prof.discard()
    assert not prof.active and prof.done
    assert not os.path.exists(tmp_path / "b")

    prof = profiling.StepProfiler(5, str(tmp_path / "c"),
                                  torch.device("cpu"), logs.append)
    run(prof, 0, 5)
    d = profiling.load_trace(str(tmp_path / "c"))
    assert profiling.table_lines(d, steps_from=0)[-1]["n_steps_traced"] == 2
    assert profiling.StepProfiler(0, "", torch.device("cpu")).span() \
        .__class__ is contextlib.nullcontext


def test_trace_context_writes_a_readable_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t"), cuda=False):
        torch.ones(16, 16) @ torch.ones(16, 16)
    assert [n for n in os.listdir(tmp_path / "t")
            if not n.endswith(profiling.TRACE_SUFFIX)] == []
    total = profiling.table_lines(profiling.load_trace(
        str(tmp_path / "t")), steps_from=0)[-1]
    assert total["timeline"] == "cpu" and total["n_steps_traced"] == 1


def test_time_fn_returns_the_jax_keys():
    a = torch.ones(8, 8)
    got = profiling.time_fn(torch.matmul, a, a, iters=3, warmup=1)
    want = jprofiling.time_fn(jnp.matmul, jnp.ones((8, 8)),
                              jnp.ones((8, 8)), iters=3, warmup=1)
    assert set(got) == set(want) == {"mean_s", "p50_s", "best_s",
                                     "iters_per_s"}
    assert 0 < got["best_s"] <= got["p50_s"]
    assert got["iters_per_s"] == pytest.approx(1 / got["mean_s"])
    assert profiling.time_fn_pipelined(torch.matmul, a, a, iters=3) > 0


def test_flops_estimate_matches_jax():
    m, k, n = 16, 32, 8
    a = np.random.default_rng(0).standard_normal((m, k)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((k, n)).astype(np.float32)
    got = profiling.flops_estimate(torch.matmul, torch.from_numpy(a),
                                   torch.from_numpy(b))
    assert got == 2 * m * n * k
    assert got == jprofiling.flops_estimate(jnp.matmul, jnp.asarray(a),
                                            jnp.asarray(b))
    assert profiling.flops_estimate(torch.relu, torch.ones(4)) is None


def test_runner_accepts_the_three_knobs(tmp_path):
    spec = ProtoSpec.equal_allocation(8, 8, num_classes=2, num_scales=4)
    bindings = parse_config("train.remat = True\n"
                            "train.fast_gradconv = True\n"
                            "train.profile_steps = 7")
    logs = []
    t = PhaseTrainer(PPNet(DeepLabV2(n_out=8, n_blocks=(1, 1, 1, 1)), spec),
                     spec, "multiscale", str(tmp_path),
                     module_hparams(bindings, "multiscale"), bindings,
                     torch.device("cpu"), log=logs.append)
    assert t.remat is True and t.profiler.n_steps == 7
    assert t.profiler.out_dir == os.path.join(str(tmp_path), "profile")
    assert t.model.features.base.fast_gradconv is True
    assert "fast_gradconv=True remat=True" in logs[0]

"""The port's planner, flow and kernel dispatch held against the
reference: the nine plan/chain/flow golden reports come out byte for
byte, plans carry equal signatures, both pattern matchers return equal
GEMM recipes, and the H100 datasheet plans the slice's batch."""
import dataclasses
import pathlib

import pytest
import torch

from repro.cfd import operators as r_operators
from repro.flow import build as r_build
from repro.flow import patterns as r_patterns
from repro.memory import chain as r_chain
from repro_torch import flow as t_flow
from repro_torch.cfd import operators as t_operators
from repro_torch.flow import patterns as t_patterns
from repro_torch.memory import chain as t_chain
from repro_torch.memory import channels, dse
from repro_torch.memory.placement import DeviceTopology

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"


def _golden(name):
    return (GOLDEN / name).read_text()


PLAN_CASES = {
    "plan_helmholtz_p7_alveo.txt": dict(policy="float32", prefetch_depth=1),
    "plan_helmholtz_p7_staged_alveo.txt": dict(
        policy="float32", backend="staged", prefetch_depth=2),
    "plan_helmholtz_p7_bf16_alveo.txt": dict(policy="bfloat16",
                                             prefetch_depth=1),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_single_op_plan_golden(name):
    plan = dse.make_plan(7, target=channels.ALVEO_U280, n_eq=1 << 16,
                         **PLAN_CASES[name])
    assert plan.report().rstrip("\n") == _golden(name).rstrip("\n")


CHAIN_CASES = {
    "chain_cfd_p5_alveo.txt": dict(batch_elements=512, prefetch_depth=1),
    "chain_cfd_p5_mixed_alveo.txt": dict(
        backends=("xla", "xla", "staged"), batch_elements=256,
        prefetch_depth=(1, 1, 2)),
    "chain_cfd_p5_sharded_alveo.txt": dict(
        batch_elements=256, prefetch_depth=(2, 1, 1), cu_count=(1, 2, 1),
        topology="2"),
    "chain_cfd_p5_hetero_alveo.txt": dict(
        batch_elements=256, prefetch_depth=(2, 1, 1), cu_count=(1, 2, 1),
        topology="cpu:1,alveo:2", stage_groups=(0, 1, 1),
        stage_batch_elements=(64, 256, 256)),
}


def _chain_kwargs(name, topology_cls):
    kw = dict(CHAIN_CASES[name])
    topo = kw.pop("topology", None)
    if topo == "2":
        kw["topology"] = topology_cls.homogeneous(2)
    elif topo is not None:
        kw["topology"] = topology_cls.parse(topo)
    return kw


@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_chain_plan_golden_and_signature(name):
    from repro.memory.channels import ALVEO_U280 as R_ALVEO
    from repro.memory.placement import DeviceTopology as RTopology

    t_plan = t_chain.plan_chain(
        t_operators.build_cfd_chain(5, device="cpu"),
        target=channels.ALVEO_U280, policy="float32", n_eq=1 << 12,
        **_chain_kwargs(name, DeviceTopology),
    )
    assert t_plan.report().rstrip("\n") == _golden(name).rstrip("\n")
    r_plan = r_chain.plan_chain(
        r_operators.build_cfd_chain(5), target=R_ALVEO, policy="float32",
        n_eq=1 << 12, **_chain_kwargs(name, RTopology),
    )
    assert t_plan.signature == r_plan.signature


@pytest.mark.parametrize("example", ["inverse_helmholtz", "cfd_pipeline"])
def test_flow_report_golden(example):
    """What ``python -m repro.flow examples/<x>.cfd --target alveo-u280``
    prints, produced by the port's flow."""
    system = t_flow.compile(
        (ROOT / "examples" / f"{example}.cfd").read_text(), name=example,
        target="alveo-u280",
    )
    assert system.report() + "\n" == _golden(f"flow_{example}.txt")


def _stage_programs(pkg_operators, cut, **kw):
    stages = pkg_operators.CFD_PIPELINE_STAGES if cut else None
    compile_fn = (t_flow.compile if pkg_operators is t_operators
                  else r_build.compile)
    system = compile_fn(pkg_operators.CFD_PIPELINE_SRC.format(p=5),
                        stages=stages, target="alveo-u280", **kw)
    return [(s.name, s.program) for s in system.chain.stages]


@pytest.mark.parametrize("cut", [True, False], ids=["named-cuts", "schedule"])
def test_matchers_agree_on_every_pipeline_stage(cut):
    t_stages = _stage_programs(t_operators, cut)
    r_stages = _stage_programs(r_operators, cut)
    assert [n for n, _ in t_stages] == [n for n, _ in r_stages]
    matched = 0
    for (name, t_prog), (_, r_prog) in zip(t_stages, r_stages):
        assert t_patterns.program_signature(t_prog) == \
            r_patterns.program_signature(r_prog), name
        t_recipe = t_patterns.match_gemm_chain(t_prog)
        r_recipe = r_patterns.match_gemm_chain(r_prog)
        assert (t_recipe is None) == (r_recipe is None), name
        if t_recipe is not None:
            assert dataclasses.astuple(t_recipe) == dataclasses.astuple(r_recipe)
            matched += 1
        assert (t_patterns.match_inverse_helmholtz(t_prog)
                == r_patterns.match_inverse_helmholtz(r_prog)), name
    assert matched >= 2


def test_pallas_dispatch_matches_reference_backends():
    kw = dict(backends="pallas", target="alveo-u280")
    t_sys = t_operators.compile_cfd_pipeline(5, **kw)
    r_sys = r_operators.compile_cfd_pipeline(5, **kw)
    assert t_sys.backends == r_sys.backends == ("pallas",) * 3
    assert t_sys.report() == r_sys.report()
    # every kernel stage runs at the block its plan sized
    assert t_sys.plan.signature == r_sys.plan.signature


def test_h100_plan_for_the_slice():
    """The H100 datasheet plans the slice: E = 50,419 (not padded: the
    kernels walk a ragged last tile), blocks 3 / 3 / 3 (each the tile
    its CUDA kernel launches with, and its CTA's shared bytes), 1,292.5
    MiB per batch over the host link, feasible."""
    system = t_operators.compile_cfd_pipeline(11, backends="pallas",
                                              target="h100-sxm")
    plan = system.plan
    assert plan.target is channels.H100_SXM and plan.feasible
    assert plan.batch_elements == 50_419 and plan.batch_pad_elements == 0
    assert [sp.block_elements for sp in plan.stages] == [3, 3, 3]
    assert [sp.block_working_set_bytes for sp in plan.stages] == [
        49_040, 35_168, 49_040]
    assert round(plan.host_stream_bytes / 2 ** 20, 1) == 1292.5
    assert plan.pipeline.pipelined
    assert system.backends == ("pallas",) * 3


def test_h100_datasheet():
    t = channels.H100_SXM
    assert channels.resolve_target("H100_SXM") is t
    assert (t.hbm_bytes, t.n_channels, t.vmem_bytes) == (80 * 2 ** 30, 80,
                                                         232_448)
    assert (t.hbm_bw, t.peak_flops, t.host_link_bw) == (3.35e12, 67e12, 64e9)
    assert t.channel_bytes == 2 ** 30


def test_detect_target_needs_the_card_unless_cpu_is_asked():
    assert channels.detect_target("cpu") is channels.CPU_HOST
    assert DeviceTopology.from_torch([torch.device("cpu")]).device_kind == "cpu"
    if torch.cuda.is_available():
        name = torch.cuda.get_device_properties(0).name
        if "H100" in name:
            assert channels.detect_target() is channels.H100_SXM
        else:
            with pytest.raises(channels.UnknownTargetError):
                channels.detect_target()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            channels.detect_target()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_operators.compile_cfd_pipeline(5)


def test_not_ported_knobs_raise(tmp_path):
    """Stage fusion, the chain DSE, measured block tuning and the profile
    store are ported: a profile (with or without block tuning) compiles,
    and a cold store plans as no store does."""
    src = t_operators.CFD_PIPELINE_SRC.format(p=3)
    store = str(tmp_path / "p.json")
    plain = t_flow.compile(src, target="cpu-host", device="cpu")
    for kw in (dict(profile=store), dict(profile=store, tune_blocks=True)):
        got = t_flow.compile(src, target="cpu-host", device="cpu", **kw)
        assert got.plan.signature == plain.plan.signature
    chain = t_operators.build_cfd_chain(3, device="cpu")
    assert t_chain.plan_chain(chain, target=channels.CPU_HOST,
                              profile=store).report() == t_chain.plan_chain(
        chain, target=channels.CPU_HOST).report()
    assert dse.explore_chain(chain, target=channels.CPU_HOST, profile=store)
    assert len(t_chain.plan_chain(chain, target=channels.CPU_HOST,
                                  max_stages=1).stages) == 1
    # the fixed-point policies compile now, but never onto a float kernel
    with pytest.raises(t_flow.FlowError, match="floating point"):
        t_flow.compile(src, target="cpu-host", policy="fixed32_q8.24",
                       backends=("xla", "xla", "pallas"))


FLOW_CASES = {
    "fixed32": dict(policy="fixed32_q8.24"),
    "fixed64-staged": dict(policy="fixed64_q24.40", backend="staged"),
    "mixed-staged": dict(backends=("staged", "xla", "staged")),
    "fixed32-staged-cpu": dict(policy="fixed32_q8.24", backend="staged",
                               target="cpu-host"),
}


@pytest.mark.parametrize("case", sorted(FLOW_CASES))
def test_flow_fixed_point_and_staged_match_reference(case):
    """``flow.compile`` with a fixed-point policy or staged stages gives
    the reference's plan, plan signature and report."""
    kw = {"target": "alveo-u280", "stages": t_operators.CFD_PIPELINE_STAGES,
          "batch_elements": 256, **FLOW_CASES[case]}
    src = t_operators.CFD_PIPELINE_SRC.format(p=5)
    want = r_build.compile(src, **kw)
    got = t_flow.compile(src, **kw)
    assert got.backends == want.backends
    assert got.plan.signature == want.plan.signature
    assert got.report() == want.report()
    assert [s.compiled.backend for s in got.chain.stages] == list(got.backends)


# ---------------------------------------------------------------------------
# the flow CLI (python -m repro_torch.flow)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("example", ["inverse_helmholtz", "cfd_pipeline"])
def test_flow_cli_matches_golden(example):
    """``python -m repro_torch.flow examples/<x>.cfd --target alveo-u280``
    prints the reference CLI's golden report byte for byte."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.flow",
         str(ROOT / "examples" / f"{example}.cfd"), "--target", "alveo-u280"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == _golden(f"flow_{example}.txt")


CLI_CASES = {
    "fuse-auto": ["--target", "tpu-v5e", "--fuse", "auto", "--n-eq", "16384"],
    "max-stages-pallas": ["--target", "alveo-u280", "--max-stages", "3",
                          "--backend", "pallas"],
    "dse": ["--target", "alveo-u280", "--dse", "--n-eq", "65536"],
    "devices-hetero": ["--target", "alveo-u280", "--devices", "cpu:1,alveo:2",
                       "--cu-count", "1", "--prefetch-depth", "2"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_flow_cli_reports_match_reference(case, capsys):
    """--fuse, --max-stages, --dse and --devices print the reference
    CLI's text (the port's own --device flag aside)."""
    from repro.flow import cli as r_cli
    from repro_torch.flow import cli as t_cli

    src = str(ROOT / "examples" / "cfd_pipeline.cfd")
    assert r_cli.main([src, *CLI_CASES[case]]) == 0
    want = capsys.readouterr().out
    assert t_cli.main([src, *CLI_CASES[case], "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


def test_flow_cli_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.flow import cli as t_cli

    src = str(ROOT / "examples" / "inverse_helmholtz.cfd")
    assert t_cli.main([src, "--device", "cpu", "--backend", "pallas",
                       "--max-stages", "3", "--run", "--n-eq", "64"]) == 0
    out = capsys.readouterr().out
    assert "ran 2 batches x" in out and "checksum" in out


@pytest.mark.parametrize("args,msg", [
    # an output path whose directory is missing fails before the run
    (["--trace", "no_such_dir/t.json"], "--trace .*no such directory"),
    # --profile records a trace, the tuner's winners or a DSE: alone (or
    # with a plain --run) it would do nothing
    (["--profile"], "--profile does nothing without --trace"),
    (["--metrics", "no_such_dir/m.json"], "--metrics .*no such directory"),
    (["--run", "--profile"], "--profile does nothing without --trace"),
    (["--target", "alveo-u28"], "did you mean"),
    (["--target", "cpu-host", "--fuse", "auto", "--cu-count", "x"],
     "bad --cu-count"),
], ids=["trace", "profile", "metrics", "tune-blocks", "target", "cu-count"])
def test_flow_cli_exit_2(args, msg, capsys):
    import re

    from repro_torch.flow import cli as t_cli

    src = str(ROOT / "examples" / "cfd_pipeline.cfd")
    assert t_cli.main([src, *args]) == 2
    assert re.search(msg, capsys.readouterr().err)


def test_flow_cli_exit_2_on_bad_sources_and_a_missing_card(tmp_path, capsys):
    from repro_torch.flow import cli as t_cli

    empty = tmp_path / "empty.cfd"
    empty.write_text("")
    assert t_cli.main([str(empty), "--target", "cpu-host"]) == 2
    assert "error:" in capsys.readouterr().err
    assert t_cli.main([str(tmp_path / "missing.cfd")]) == 2
    assert "error:" in capsys.readouterr().err
    if not torch.cuda.is_available():
        src = str(ROOT / "examples" / "cfd_pipeline.cfd")
        assert t_cli.main([src]) == 2          # detect needs the card
        assert "--device cpu" in capsys.readouterr().err
        assert t_cli.main([src, "--target", "h100-sxm", "--run"]) == 2
        assert "--device cpu" in capsys.readouterr().err


def test_docstring_lint_clean_on_the_ports_planner_packages():
    """Every public name of the port's flow and memory packages (the
    fusion, chain-DSE and CLI modules among them) is documented, by the
    lint the reference's planner packages pass."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "docstring_lint", ROOT / "tools" / "docstring_lint.py")
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    violations = lint.lint_paths([ROOT / "src" / "repro_torch" / "flow",
                                  ROOT / "src" / "repro_torch" / "memory"])
    assert violations == [], violations

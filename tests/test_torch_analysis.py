"""``repro_torch.analysis`` held against ``repro.analysis``: the HLO
collective parser on the reference's own strings, the report's terms at
the H100's constants, ``model_flops``, ``format_table``, and the
aggregate tables text for text on the same records."""
import json
import os

import pytest

from repro.analysis import aggregate as r_aggregate
from repro.analysis import roofline as r_roofline
from repro_torch.analysis import aggregate, roofline
from repro_torch.memory import channels

BASIC_HLO = """
  %all-reduce.1 = f32[1024,512]{1,0} all-reduce(%add.3), channel_id=1
  %ag = bf16[8,256]{1,0} all-gather(%p0), dimensions={0}
  %rs = f32[128]{0} reduce-scatter(%x), dimensions={0}
  %cp = f32[64,64]{1,0} collective-permute(%y), source_target_pairs={{0,1}}
  %unrelated = f32[2,2]{1,0} add(%a, %b)
"""
ASYNC_HLO = """
  %a2a = (f32[8,16]{1,0}, f32[8,16]{1,0}) all-to-all(%x, %y), dimensions={0}
  %ar-start = f32[100]{0} all-reduce-start(%z), channel_id=3
  %ar-done = f32[100]{0} all-reduce-done(%ar-start)
"""


def test_collective_parser_basic():
    got = roofline.collective_bytes(BASIC_HLO)
    assert got["all-reduce"] == 1024 * 512 * 4
    assert got["all-gather"] == 8 * 256 * 2
    assert got["reduce-scatter"] == 128 * 4
    assert got["collective-permute"] == 64 * 64 * 4
    assert got == r_roofline.collective_bytes(BASIC_HLO)


def test_collective_parser_tuple_and_async():
    got = roofline.collective_bytes(ASYNC_HLO)
    assert got["all-to-all"] == 2 * 8 * 16 * 4
    assert got["all-reduce"] == 100 * 4  # start counted, done not
    assert got == r_roofline.collective_bytes(ASYNC_HLO)


def test_constants_are_the_h100_datasheet():
    """One source with the planner (the port's
    test_roofline_shares_channel_constants): HBM and NVLink from
    ``H100_SXM``, the peak the named dense bf16 tensor-core rate, not
    ``H100_SXM.peak_flops`` (the f32 CUDA-core rate the CFD plans use)."""
    assert roofline.HBM_BW == channels.H100_SXM.hbm_bw == 3.35e12
    assert roofline.ICI_LINK_BW == channels.H100_SXM.ici_bw == 450e9
    assert roofline.PEAK_FLOPS_BF16 == channels.H100_SXM_BF16_FLOPS == 989e12
    assert channels.H100_SXM.peak_flops == 67e12


def _report(**kw):
    base = dict(arch="a", shape="s", mesh="single", chips=256,
                coll_breakdown={}, bytes_per_device=10)
    base.update(kw)
    return roofline.RooflineReport(**base)


def test_report_terms_and_bottleneck():
    r = _report(
        device_flops=989e12,            # exactly 1 s of compute
        device_bytes=3.35e12 * 0.5,     # 0.5 s of memory
        coll_bytes=450e9 * 0.25,        # 0.25 s of collectives
        model_flops=989e12 * 256 * 0.8,
    )
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(0.25)
    assert r.bottleneck == "compute"
    assert r.useful_flops_ratio == pytest.approx(0.8)
    assert r.roofline_fraction == pytest.approx(1.0)


@pytest.mark.parametrize("terms,bound", [((0.1, 2.0, 0.5), "memory"),
                                         ((0.1, 0.2, 3.0), "collective")])
def test_report_bottleneck_and_fraction_other_terms(terms, bound):
    tc, tm, tx = terms
    r = _report(device_flops=989e12 * tc, device_bytes=3.35e12 * tm,
                coll_bytes=450e9 * tx, model_flops=0.0)
    assert r.bottleneck == bound
    assert r.roofline_fraction == pytest.approx(tc / max(terms))
    d = r.to_dict()
    assert d["bottleneck"] == bound and d["t_memory"] == pytest.approx(tm)
    assert d["useful_flops_ratio"] == 0.0


def test_model_flops():
    assert roofline.model_flops(params=10, tokens=5, kind="train") == 300
    assert roofline.model_flops(params=10, tokens=5, kind="prefill") == 100
    assert roofline.model_flops(
        params=10, tokens=5, kind="train", active_params=4
    ) == 120
    for kw in ({"params": 7, "tokens": 3, "kind": "decode"},
               {"params": 7, "tokens": 3, "kind": "train",
                "active_params": 2}):
        assert roofline.model_flops(**kw) == r_roofline.model_flops(**kw)


def _both_reports(**kw):
    fields = dict(arch="x", shape="train_4k", mesh="single", chips=256,
                  device_flops=1e12, device_bytes=1e12, coll_bytes=1e9,
                  coll_breakdown={}, bytes_per_device=2 ** 30,
                  model_flops=1e14)
    fields.update(kw)
    return (roofline.RooflineReport(**fields),
            r_roofline.RooflineReport(**fields))


def test_format_table_runs():
    r, _ = _both_reports()
    s = roofline.format_table([r])
    assert "train_4k" in s and "memory" in s


def test_format_table_layout_is_the_references():
    """Same columns and formats; the numbers differ only by the
    constants (the same terms at the H100's rates)."""
    mine, ref = _both_reports(device_flops=0.0, device_bytes=0.0,
                              coll_bytes=0.0)
    assert roofline.format_table([mine]) == r_roofline.format_table([ref])
    a, b = (roofline.format_table([x]).splitlines() for x in _both_reports())
    assert a[:2] == b[:2] and len(a) == len(b) == 3


def test_analyze_sums_the_dry_runs_counts():
    counts = {"flops": 989e12, "bytes": 3.35e12,
              "collectives": {"all-reduce": 450e9, "all-gather": 0},
              "memory": {"argument_size_in_bytes": 3,
                         "output_size_in_bytes": 4,
                         "temp_size_in_bytes": 5,
                         "alias_size_in_bytes": 3}}
    r = roofline.analyze(counts, arch="a", shape="s", mesh_name="single",
                         chips=2, model_flops_value=1.0,
                         extra_flops=989e12, extra_bytes=3.35e12)
    assert r.t_compute == pytest.approx(2.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.coll_breakdown["all-reduce"] == 450e9
    assert r.coll_breakdown["all-to-all"] == 0
    assert r.bytes_per_device == 12


def _records():
    """Dry-run records of every status on both meshes, as the dry run
    writes them."""
    def ok(arch, shape, mesh, s):
        r, _ = _both_reports(arch=arch, shape=shape, mesh=mesh,
                             device_flops=1e12 * s, device_bytes=2e11 * s,
                             coll_bytes=3e9 * s)
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "compile_s": 3.5 * s, "roofline": r.to_dict(),
                "memory_analysis": {"argument_size_in_bytes": 2 ** 31 * s,
                                    "temp_size_in_bytes": 2 ** 28 * s}}

    recs = []
    for mesh in ("single", "multipod"):
        recs += [ok("b-arch", "train_4k", mesh, 1.0),
                 ok("a-arch", "decode_32k", mesh, 1e-4),
                 ok("a-arch", "train_4k", mesh, 2.0)]
        recs.append({"arch": "a-arch", "shape": "long_500k", "mesh": mesh,
                     "status": "skipped",
                     "reason": "long_500k needs sub-quadratic attention; x"})
    recs.append({"arch": "c-arch", "shape": "prefill_32k", "mesh": "single",
                 "status": "error", "error": "RuntimeError: " + "e" * 80})
    return recs


def test_aggregate_tables_are_the_references_text(tmp_path):
    recs = _records()
    for i, r in enumerate(recs):
        with open(os.path.join(tmp_path, f"{i:02d}.json"), "w") as f:
            json.dump(r, f)
    loaded = aggregate.load(str(tmp_path))
    assert loaded == r_aggregate.load(str(tmp_path)) and len(loaded) == 9
    assert aggregate.dryrun_summary(loaded) == r_aggregate.dryrun_summary(
        loaded)
    for mesh in ("single", "multipod"):
        got = aggregate.roofline_table(loaded, mesh)
        assert got == r_aggregate.roofline_table(loaded, mesh)
        assert "*skipped*" in got
    assert "ERROR" in aggregate.roofline_table(loaded, "single")
    for x in (0, 5e-7, 0.02, 3.0):
        assert aggregate.fmt_s(x) == r_aggregate.fmt_s(x)


def test_aggregate_main_prints_both_meshes(tmp_path, capsys, monkeypatch):
    for i, r in enumerate(_records()):
        with open(os.path.join(tmp_path, f"{i:02d}.json"), "w") as f:
            json.dump(r, f)
    monkeypatch.setattr("sys.argv", ["aggregate", str(tmp_path)])
    aggregate.main()
    mine = capsys.readouterr().out
    r_aggregate.main()
    assert mine == capsys.readouterr().out
    assert "cells: 6 compiled ok, 2 ruled skips, 1 errors" in mine


def test_aggregate_marks_the_modelled_terms_of_a_composed_cell():
    """A composed cell (``scancost``) whose collective, bytes and
    temporaries checks failed: its t_mem, t_coll, bound and temporaries
    carry the mark, its t_comp and arguments (exact) do not, and a line
    under the table says what the mark means; the other rows keep the
    reference's text.  A composed cell whose every check held is a
    count: no mark."""
    recs = [r for r in _records() if r["mesh"] == "single"]
    check = {"flops": True, "bytes": False, "coll/all-reduce": False,
             "coll/all-gather": True, "memory/argument_size_in_bytes": True,
             "memory/temp_size_in_bytes": False}
    composed = dict(recs[0], arch="z-arch",
                    scan_correction={"detail": {"check": check}})
    assert aggregate.modelled(composed) == {
        "t_memory", "t_collective", "temp_size_in_bytes"}
    assert aggregate.modelled(recs[0]) == set()
    held = dict(composed, scan_correction={"detail": {"check": dict.fromkeys(
        check, True)}})
    assert aggregate.modelled(held) == set()
    want = r_aggregate.roofline_table(recs + [composed], "single")
    got = aggregate.roofline_table(recs + [composed], "single")
    *rows, blank, note = got.splitlines()
    assert blank == "" and note.startswith(aggregate.MODELLED + ":")
    row = rows[-1].split(" | ")
    assert row[2:6] == ["1.01ms", "~59.7ms", "~6.67ms", "~memory"]
    assert row[8] == "2.0+~0.2 |"
    assert rows[:-1] == want.splitlines()[:-1]
    assert aggregate.roofline_table(recs, "single") == (
        r_aggregate.roofline_table(recs, "single"))

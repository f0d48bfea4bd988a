"""tools/host_calls.py, the count of top-level torch calls, rng draws and
host ms per frame, rehearsed on the CPU at a tiny size.  On the CPU every
draw takes the plain twin, so the tool records no kernel draw and no
saving; on the card it runs at 512^2 (README.md).  No JAX."""

import json

import torch

from ti_raytrace_tpu_torch.tools import host_calls

torch.set_num_threads(2)


def test_draw_calls_on_cpu_are_the_plain_twins():
    calls = host_calls.draw_calls((8, 64), torch.device("cpu"))
    assert calls["kernel"] == calls["plain"] >= 150


def test_main_writes_a_row_per_path(tmp_path, capsys):
    out = tmp_path / "calls.json"
    host_calls.main(["--device", "cpu", "--size", "8", "--frames", "1", "--reps", "2",
                     "--paths", "cornell_box,veach_pt", "--out", str(out)])
    res = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["card"] == "cpu" and res["size"] == 8
    rows = {r["path"]: r for r in res["paths"]}
    assert list(rows) == ["veach_pt", "cornell_box"]  # PATHS' order
    for r in rows.values():
        assert r["integrator"] == "pt_rgb" and r["frames_per_call"] == 1
        assert len(r["ms_per_frame"]) == 2 and min(r["ms_per_frame"]) > 0.0
        assert r["calls_per_frame"] > 1000 and r["overflow"] == 0
        assert r["draws_per_frame"] == 0 and r["calls_saved_per_frame"] == 0
        assert r["hdr_mean"] > 0.0

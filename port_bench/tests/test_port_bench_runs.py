"""Both drivers end to end at the tiny widths on the CPU: a well-formed
last line, the port agreeing with the reference in fp32, the
lower-precision controls and the planted faults coming out not correct, and
a cell, a configuration and a metric added as files alone."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from port_bench import run, spec


def last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def drive(capsys, cell: str, trace: int = 0, seed: int = 3_000_000_000):
    run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1.5",
              "--trace", str(trace)], device="cpu")
    return last_line(capsys)


@pytest.mark.parametrize("cell,trace", [("train.tiny", 0), ("train.tiny", 1),
                                        ("serve.tiny", 0), ("serve.tiny", 1)])
def test_last_line(bench_copy, capsys, cell, trace):
    line = drive(capsys, cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["device"]["count"] == 1
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    kind = cell.split(".")[0]
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"window_s", "busy_s"} <= set(line["device"])
        assert all(not k.endswith(".train" if kind == "serve" else ".serve")
                   for k in line["metrics"])
    else:
        assert set(line["metrics"]) == {
            "setup_s", "train_pairs_per_s" if kind == "train"
            else "serve_p95_ms"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_agrees_in_fp32(bench_copy):
    """The port's fp32 step and server against the reference: every number
    far inside the tiny cells' fp32 limits."""
    from port_bench.drivers import serve, train
    dev = torch.device("cpu")
    cell = spec.cell("train.tiny")
    rows = train.calibrate(cell, [1, 2], ["program"], dev)
    for row in rows:
        for k, limit in cell["limits"].items():
            assert row[k] <= limit / 3, (k, row)
    cell = spec.cell("serve.tiny")
    for row in serve.calibrate(cell, [1, 2], ["program"], dev, seconds=1.0):
        assert row["wrong"] == 0
        assert row["embed_gap"] <= cell["limits"]["embed_gap"] / 3, row


def retarget(root, cell: str, config: str, traffic: str = None) -> str:
    """A copy of ``cell``'s file under another name, on ``config``."""
    c = json.loads((root / "workloads" / f"{cell}.json").read_text())
    c["config"] = config
    if traffic:
        c["traffic"] = traffic
    name = f"{cell}.{config}"
    (root / "workloads" / f"{name}.json").write_text(json.dumps(c))
    return name


def test_controls_fail(bench_copy, capsys):
    """One precision below the configuration's, each cell comes out not
    correct: the training step in bf16 (and the port's own int8 path)
    against the fp32 cell's limits, and the serving reference's fp8 control
    against the fp32 serving cell's."""
    from port_bench.drivers import serve, train
    dev = torch.device("cpu")
    cell = spec.cell("train.tiny")
    bf16 = dict(cell, traffic=dict(cell["traffic"], amp=True))
    for rows in (train.calibrate(bf16, [1], ["program"], dev),
                 train.calibrate(cell, [1], ["control"], dev)):
        assert any(rows[0][k] > v for k, v in cell["limits"].items()), rows
    c = json.loads((bench_copy / "traffic" / "tiny-sparc-fp32.json")
                   .read_text())
    (bench_copy / "traffic" / "tiny-sparc-bf16.json").write_text(
        json.dumps(dict(c, amp=True)))
    name = retarget(bench_copy, "train.tiny", "tiny", "tiny-sparc-bf16")
    assert drive(capsys, name)["correct"] is False
    cell = spec.cell("serve.tiny")
    row = serve.calibrate(cell, [1], ["control"], dev)[0]
    assert row["embed_gap"] > cell["limits"]["embed_gap"]
    assert drive(capsys, retarget(bench_copy, "serve.tiny", "tiny"))[
        "correct"] is False


def frozen_state(monkeypatch):
    """A step that returns its state unchanged: the optimizer never moves."""
    from clip_finegrained_alignment_tpu_torch.optim import factory
    monkeypatch.setattr(factory.ClippedOptimizer, "step",
                        lambda self: torch.zeros(()))


def half_batch(monkeypatch):
    """Half of each microbatch left out, the mean taken over the rest."""
    from clip_finegrained_alignment_tpu_torch.train import engine
    from port_bench.drivers import train
    monkeypatch.setattr(engine, "compute_loss", engine.compute_loss)
    train.half_batch(engine)


def altered_answer(monkeypatch):
    """One served embedding altered where it is produced."""
    from clip_finegrained_alignment_tpu_torch.models import inference
    embed = inference.CLIPInference.embed_images_device

    def altered(self, pixels):
        e = embed(self, pixels).clone()
        e[0] = -e[0]
        return e
    monkeypatch.setattr(inference.CLIPInference, "embed_images_device",
                        altered)


@pytest.mark.parametrize("cell,fault", [
    ("train.tiny", frozen_state), ("train.tiny", half_batch),
    ("serve.tiny", altered_answer)])
def test_faults_fail(bench_copy, capsys, monkeypatch, cell, fault):
    """The timed path broken underneath: ``correct`` comes out false. (The
    cells run on one chip: no exchange between chips to leave out.)"""
    fault(monkeypatch)
    assert drive(capsys, cell)["correct"] is False


def test_knee_sweep(bench_copy, capsys):
    """The sweep runs one server through each rate, a row a rate, and names
    the highest rate that kept up."""
    from port_bench import knee_sweep
    rows = knee_sweep.main(["--workload", "serve.tiny", "--seconds", "1.5",
                            "--rates", "10", "20"], device="cpu")
    assert [r["offered_requests_per_s"] for r in rows] == [10.0, 20.0]
    assert all(r["failed"] == 0 for r in rows)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["knee_requests_per_s"] == max(
        [r["offered_requests_per_s"] for r in rows if r["keeps_up"]],
        default=None)


def test_train_traffic_with_other_objective_refused(bench_copy, capsys):
    """The training driver runs SPARC + AdamSPD alone: a traffic file that
    names another loss is refused before any run, with no result line."""
    c = json.loads((bench_copy / "traffic" / "tiny-sparc-fp32.json")
                   .read_text())
    (bench_copy / "traffic" / "tiny-count.json").write_text(
        json.dumps(dict(c, loss="count")))
    name = retarget(bench_copy, "train.tiny", "tiny-fp32", "tiny-count")
    with pytest.raises(SystemExit) as e:
        drive(capsys, name)
    assert e.value.code == 2
    out, err = capsys.readouterr()
    assert out == "" and "'loss'" in err


def test_added_files_are_enough(bench_copy, capsys):
    """A configuration, a cell and a per-layer metric added as files alone
    run, the metric read in the traced run's line."""
    cfg = json.loads((bench_copy / "configs" / "tiny-fp32.json").read_text())
    cfg["vision_config"]["num_hidden_layers"] = 1
    (bench_copy / "configs" / "tiny-one-layer.json").write_text(
        json.dumps(cfg))
    name = retarget(bench_copy, "train.tiny", "tiny-one-layer")
    (bench_copy / "metrics" / "records.train.py").write_text(
        "UNIT = 'records'\n\n\ndef read(ctx):\n"
        "    return 7.0 if ctx.get('kind') == 'train' else None\n")
    line = drive(capsys, name, trace=1)
    assert line["correct"] is True
    assert line["metrics"]["records.train"] == {"value": 7.0,
                                                "unit": "records"}
    shutil.rmtree(bench_copy / "metrics")
    (bench_copy / "metrics").mkdir()
    assert drive(capsys, name, trace=1)["metrics"] == {}


@pytest.mark.card
@pytest.mark.parametrize("cell,modes", [
    ("train.b16.sparc-mb128", ["program", "control", "half_batch"]),
    ("serve.l14-336.image-raw", ["program", "control"])])
def test_control_at_cell_size(card, cell, modes):
    """On the card at the cell's own size, three seeds: the control and the
    planted fault fail one of the cell's limits; the program passes all."""
    from port_bench import calibrate
    limits = spec.cell(cell)["limits"]
    rows = calibrate.main(["--workload", cell, "--seeds", "7001", "7002",
                           "7003", "--modes", *modes])
    for row in rows:
        over = [k for k, v in limits.items() if row[k] > v]
        assert (not over) == (row["mode"] == "program"), row

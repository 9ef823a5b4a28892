"""The port's evaluation layer (``clip_finegrained_alignment_tpu_torch/
eval/`` and ``data/fixtures.py``) against the JAX package's, on the CPU.

Both sides get the same tiny-config weights (the JAX tree, carried across
with ``state_dict_from_jax``), the same ``HashTokenizer`` ids and the same
numpy inputs from a seed. The port runs the plain version of the attention
kernel (#1); the JAX side runs its XLA path and, for the scorer, also the
Pallas kernel in interpret mode.

Exact equality: templates, number extraction, padding, the decision rule
(ties and the no-negatives case included), VLMs-are-Blind templates and
validation, crop geometry, fixture JSON and PNG bytes, ``CocoObjectSource``
draws (one stub ``pycocotools.coco`` serves both packages), and every
decision, predicted template and number of the evaluators. Within 1e-5
(fp32, other summation orders): probabilities, similarities, confidences
and confusion matrices. The JAX scorer pads short batches
(``pad_to_batch``); the port's runs them at their own size.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.config import CLIPConfig as JaxCLIPConfig
from clip_finegrained_alignment_tpu.data import fixtures as jfix
from clip_finegrained_alignment_tpu.data.tokenizer import \
    HashTokenizer as JaxHashTokenizer
from clip_finegrained_alignment_tpu.eval import batch_eval as jbe
from clip_finegrained_alignment_tpu.eval import countbench as jcb
from clip_finegrained_alignment_tpu.eval import crop_detection as jcd
from clip_finegrained_alignment_tpu.eval import scoring as jsc
from clip_finegrained_alignment_tpu.eval import vlmsblind as jvb
from clip_finegrained_alignment_tpu.models import clip as jm
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
from clip_finegrained_alignment_tpu_torch.data import fixtures as tfix
from clip_finegrained_alignment_tpu_torch.data.tokenizer import HashTokenizer
from clip_finegrained_alignment_tpu_torch.eval import batch_eval as tbe
from clip_finegrained_alignment_tpu_torch.eval import countbench as tcb
from clip_finegrained_alignment_tpu_torch.eval import crop_detection as tcd
from clip_finegrained_alignment_tpu_torch.eval import scoring as tsc
from clip_finegrained_alignment_tpu_torch.eval import vlmsblind as tvb
from clip_finegrained_alignment_tpu_torch.models.convert import \
    state_dict_from_jax

TOL = dict(rtol=0, atol=1e-5)
CFG, JCFG = CLIPConfig.tiny_test(), JaxCLIPConfig.tiny_test()
T = CFG.text.max_position_embeddings


def _tok(cls):
    t = CFG.text
    return cls(vocab_size=t.vocab_size, bos_token_id=t.bos_token_id,
               eos_token_id=t.eos_token_id, pad_token_id=t.pad_token_id)


TOK, JTOK = _tok(HashTokenizer), _tok(JaxHashTokenizer)


@pytest.fixture(scope="module")
def weights():
    params = jm.init_clip_params(jax.random.key(0), JCFG)
    return params, state_dict_from_jax(params, CFG)


@pytest.fixture(scope="module")
def cb_samples(tmp_path_factory):
    """A small CountBench fixture plus the samples the evaluator skips or
    cannot template (no image, a number out of range, no number)."""
    root = tmp_path_factory.mktemp("cb")
    samples = tfix.make_countbench_fixture(str(root), num_samples=10,
                                           image_size=64, seed=3)
    for s in samples:
        s["image"] = s["image_path"]
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    return samples + [
        {"image": None, "text": "A photo of two cats.", "number": 2},
        {"image": img, "text": "A photo of 15 dogs.", "number": 15},
        {"image": img, "text": "A photo of some dogs.", "number": 3},
        {"image": img, "text": "Four red circles and 4 more.", "number": 4},
    ]


# ---------------------------------------------------------------------------
# Exact equality of the host-side helpers
# ---------------------------------------------------------------------------

CAPTIONS = [("A photo of 3 cats", 3), ("Two dogs and two cats", 2),
            ("twelve eggs in a box", 12), ("1 apple", 1),
            ("A photo of Eleven players.", 11), ("no number here", 5),
            ("A photo of 10 red circles.", 10), ("seven seven 7", 7)]


@pytest.mark.parametrize("number_format", ["numeric", "word", "both"])
def test_generate_templates_equal_jax(number_format):
    for text, n in CAPTIONS:
        got = tcb.generate_templates(text, n, number_format)
        assert got == jcb.generate_templates(text, n, number_format), text
    texts = [t for t, _ in CAPTIONS] + [
        "thirteen birds", "20 kids and nineteen adults", "0 cats",
        "13 and twelve", "", "A photo of 99 things"]
    for t in texts:
        assert tcb.extract_number(t) == jcb.extract_number(t), t
    for n in range(1, 13):
        assert tcb.format_number(n, number_format) == \
            jcb.format_number(n, number_format)


def test_pad_templates_and_decision_equal_jax():
    rng = np.random.default_rng(0)
    ragged = [rng.integers(1, 200, (k, T)).astype(np.int32)
              for k in (1, 3, 7, 12)]
    pos_idx = [[0], [0, 2], [1, 6], [0, 11]]
    for want, got in zip(jsc.pad_templates(ragged, pos_idx, 10, T, 0),
                         tsc.pad_templates(ragged, pos_idx, 10, T, 0)):
        np.testing.assert_array_equal(got, want)
    ids, valid, pos = tsc.pad_templates(ragged, pos_idx, 10, T, 0)
    probs = rng.random((4, 10)).astype(np.float32)
    probs[1, :3] = [0.4, 0.2, 0.4]            # a tie between pos and neg
    cases = [(probs, pos, valid)]
    # no negatives: best_neg is 0.0 (the reference's default)
    only_pos = np.zeros((2, 10), np.float32)
    only_pos[:, 0] = 1.0
    cases.append((only_pos.copy(), only_pos, only_pos))
    for p, pm, vm in cases:
        for conf, margin in ((0.2, 0.01), (0.0, 0.0), (0.5, 0.1)):
            a = tsc.thresholded_decision(p, pm, vm, conf, margin)
            b = jsc.thresholded_decision(p, pm, vm, conf, margin)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tsc.thresholded_decision(*cases[1], 0.5, 0.1)["correct"].all()


GROUNDTRUTHS = ["Yes", "no", "maybe", 0, 2, 3, 5, 9, 10, "a", "f", "z", "K",
                "3,4", "3x9", "10,10", "2,5", "11x3", "4", None, "",
                "x,y"]


@pytest.mark.parametrize("task", jvb.TASKS + ("Something Else",))
def test_vlmsblind_templates_and_validation_equal_jax(task):
    for gt in GROUNDTRUTHS:
        assert tvb.validate_groundtruth(task, gt) == \
            jvb.validate_groundtruth(task, gt), gt
        assert tvb.negative_templates(task, gt) == \
            jvb.negative_templates(task, gt), gt
        if jvb.validate_groundtruth(task, gt):
            assert tvb.positive_templates(task, gt) == \
                jvb.positive_templates(task, gt), gt


def test_crop_geometry_equal_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        h, w = (int(v) for v in rng.integers(40, 500, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        bw, bh = (int(v) for v in rng.integers(2, 20, 2))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        for ratio in (0.05, 0.10, 0.5):
            a, abox = tcd.crop_to_target_ratio(img, [x, y, bw, bh], ratio)
            b, bbox = jcd.crop_to_target_ratio(img, [x, y, bw, bh], ratio)
            np.testing.assert_array_equal(a, b)
            assert abox == bbox
        assert tcd.box_area_ratio([x, y, bw, bh], w, h) == \
            jcd.box_area_ratio([x, y, bw, bh], w, h)
    np.testing.assert_array_equal(tcd.white_square_image(64),
                                  jcd.white_square_image(64))


@pytest.mark.parametrize("which", ["countbench", "vlmsblind"])
def test_fixtures_equal_jax_bytes(tmp_path, which):
    make = {"countbench": ("make_countbench_fixture", dict(num_samples=12)),
            "vlmsblind": ("make_vlmsblind_fixture", dict(per_task=3))}
    name, kw = make[which]
    port = getattr(tfix, name)(str(tmp_path / "port"), image_size=96,
                               seed=4, **kw)
    ref = getattr(jfix, name)(str(tmp_path / "jax"), image_size=96, seed=4,
                              **kw)
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert a["image_path"].replace("port", "jax") == b["image_path"]
        assert {k: v for k, v in a.items() if k != "image_path"} == \
            {k: v for k, v in b.items() if k != "image_path"}
        with open(a["image_path"], "rb") as fa, \
                open(b["image_path"], "rb") as fb:
            assert fa.read() == fb.read()
    js = f"{which}_fixture.json"
    with open(tmp_path / "port" / js) as fa, open(tmp_path / "jax" / js) as fb:
        assert fa.read().replace("port", "jax") == fb.read()


def test_coco_object_source_equal_jax(tmp_path, monkeypatch):
    """One stub ``pycocotools.coco.COCO`` over a small on-disk COCO tree:
    both packages draw the same images, boxes and names."""
    from PIL import Image
    rng = np.random.default_rng(2)
    (tmp_path / "val").mkdir()
    cats = [{"id": i + 1, "name": n} for i, n in
            enumerate(["cat", "dog", "car", "cup"])]
    imgs, anns = {}, []
    for i in range(6):
        w, h = 120 + 10 * i, 100
        name = f"{i:03d}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(tmp_path / "val" / name)
        imgs[i] = {"id": i, "width": w, "height": h, "file_name": name}
        # image 0: two small cats (rejected); 1: one small dog + big cat;
        # others: one small object each, except 5 which has none small
        spec = {0: [(1, 4), (1, 4)], 1: [(2, 5), (1, 60)], 5: [(3, 50)]}
        for cat, side in spec.get(i, [(1 + i % 4, 6), (1 + (i + 1) % 4, 40)]):
            anns.append({"id": len(anns), "image_id": i, "category_id": cat,
                         "bbox": [3.0, 4.0, float(side), float(side)]})

    class COCO:
        def __init__(self, path):
            assert path == str(tmp_path / "annotations" /
                               "instances_val.json")
            self.imgs = imgs

        def getCatIds(self):
            return [c["id"] for c in cats]

        def loadCats(self, ids):
            return [c for c in cats if c["id"] in ids]

        def getAnnIds(self, imgIds):
            return [a["id"] for a in anns if a["image_id"] == imgIds]

        def loadAnns(self, ids):
            return [anns[i] for i in ids]

    pkg = types.ModuleType("pycocotools")
    mod = types.ModuleType("pycocotools.coco")
    mod.COCO = COCO
    pkg.coco = mod
    monkeypatch.setitem(sys.modules, "pycocotools", pkg)
    monkeypatch.setitem(sys.modules, "pycocotools.coco", mod)
    a = tcd.CocoObjectSource(str(tmp_path), split="val", seed=7)
    b = jcd.CocoObjectSource(str(tmp_path), split="val", seed=7)
    assert a.categories == b.categories
    for _ in range(12):
        (ia, ba, ta, fa), (ib, bb, tb, fb) = a.sample(), b.sample()
        np.testing.assert_array_equal(ia, ib)
        assert (ba, ta, fa) == (bb, tb, fb)
        assert ta != "cat" or ba[2] != 4      # image 0 is never drawn


@pytest.mark.parametrize("seed", [0, 3])
def test_procedural_object_source_equal_jax(seed):
    a = tcd.ProceduralObjectSource(image_size=128, seed=seed)
    b = jcd.ProceduralObjectSource(image_size=128, seed=seed)
    for _ in range(4):
        (ia, ba, ta, fa), (ib, bb, tb, fb) = a.sample(), b.sample()
        np.testing.assert_array_equal(ia, ib)
        assert (ba, ta, fa) == (bb, tb, fb)


# ---------------------------------------------------------------------------
# The scorer and the batch eval against JAX (within 1e-5)
# ---------------------------------------------------------------------------

def _scorer_inputs(rng, B=5, NT=4):
    px = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 250, (B, NT, T)).astype(np.int32)
    ids[..., -1] = CFG.text.eos_token_id
    mask = np.ones((B, NT), np.float32)
    mask[1, 3] = mask[2, 2:] = mask[4, 1:] = 0.0   # masked template slots
    return px, ids, mask


@pytest.mark.parametrize("use_pallas", [False, True])
def test_template_scorer_matches_jax(weights, use_pallas):
    params, sd = weights
    px, ids, mask = _scorer_inputs(np.random.default_rng(7))
    port = tsc.TemplateScorer(sd, CFG, device="cpu")
    ref = jsc.TemplateScorer(params, JCFG, use_pallas=use_pallas,
                             pad_to_batch=8)(px, ids, mask)
    got = port(px, ids, mask)
    assert got.shape == ref.shape == (5, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    assert (got[mask == 0] == 0).all()
    assert port.model.training is False and port.device.type == "cpu"


def test_template_scorer_refuses_a_missing_card(weights):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs none")
    with pytest.raises(RuntimeError, match="cuda"):
        tsc.TemplateScorer(weights[1], CFG)


def _count_batch(rng, B=6, uint8=True):
    ids = rng.integers(1, 250, (B, T)).astype(np.int32)
    ids[:, -1] = CFG.text.eos_token_id
    cf = rng.integers(1, 250, (B, 9, T)).astype(np.int32)
    cf[..., -1] = CFG.text.eos_token_id
    counts = np.array([1, 3, 5, 10, 3, 7], np.int32)[:B]
    cf_counts = np.stack([[c for c in range(1, 11) if c != g]
                          for g in counts]).astype(np.int32)
    px = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    if not uint8:
        px = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    return {"pixel_values": px, "input_ids": ids, "cf_input_ids": cf,
            "count": counts, "cf_counts": cf_counts}


@pytest.mark.parametrize("pixels", ["uint8", "float"])
def test_evaluate_batch_matches_jax(weights, tmp_path, pixels):
    params, sd = weights
    batch = _count_batch(np.random.default_rng(11), uint8=pixels == "uint8")
    png = str(tmp_path / "confusion.png")
    acc, conf, res = tbe.evaluate_batch(sd, CFG, batch, device="cpu",
                                        filename=png)
    racc, rconf, rres = jbe.evaluate_batch(params, JCFG, batch)
    assert os.path.getsize(png) > 0
    assert acc == racc and conf.shape == (10, 10)
    np.testing.assert_allclose(conf, rconf, **TOL)
    for g in set(batch["count"].tolist()):
        np.testing.assert_allclose(conf[g - 1].sum(), 1.0, atol=1e-6)
    for a, b in zip(res, rres):
        assert {k: a[k] for k in ("true_count", "pred_count", "correct")} \
            == {k: b[k] for k in ("true_count", "pred_count", "correct")}
        np.testing.assert_allclose(a["similarities"], b["similarities"],
                                   **TOL)


# ---------------------------------------------------------------------------
# The evaluators against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scorers(weights):
    """One scorer a side, shared by the evaluators (the JAX one compiles
    once per shape)."""
    params, sd = weights
    return (tsc.TemplateScorer(sd, CFG, device="cpu"),
            jsc.TemplateScorer(params, JCFG, pad_to_batch=4))


class Recorder:
    """A scorer that keeps every probability matrix it returns."""

    def __init__(self, scorer):
        self.scorer, self.probs = scorer, []

    def __call__(self, *args):
        self.probs.append(self.scorer(*args))
        return self.probs[-1]


def _clear_rows(port, ref):
    """Both sides' probabilities within TOL; the rows whose reference top
    two differ by more than TOL. In the others (templates that the tiny
    vocabulary's hash collisions make identical) the argmax is a tie that
    either side may break either way."""
    got, want = np.concatenate(port.probs), np.concatenate(ref.probs)
    np.testing.assert_allclose(got, want, **TOL)
    top = np.sort(want, axis=-1)
    return top[:, -1] - top[:, -2] > TOL["atol"]


def _assert_results_match(got, ref, exact, close):
    assert set(got) == set(ref)
    for k in exact:
        assert got[k] == ref[k], k
    for k in close:
        np.testing.assert_allclose(got[k], ref[k], **TOL)


@pytest.mark.parametrize("position", ["first", "random"])
@pytest.mark.parametrize("number_format", ["numeric", "word", "both"])
def test_countbench_evaluator_matches_jax(weights, scorers, cb_samples,
                                          tmp_path, position,
                                          number_format):
    params, sd = weights
    kw = dict(number_format=number_format, template_position=position,
              batch_size=4, seed=1)
    port = tcb.CountBenchEvaluator(sd, CFG, tokenizer=TOK, device="cpu",
                                   **kw)
    ref = jcb.CountBenchEvaluator(params, JCFG, tokenizer=JTOK, **kw)
    port.scorer, ref.scorer = (Recorder(s) for s in scorers)
    res, rres = port.evaluate_dataset(cb_samples), \
        ref.evaluate_dataset(cb_samples)
    assert len(res["correct"]) == 11      # 10 fixture samples + "Four ..."
    clear = _clear_rows(port.scorer, ref.scorer)
    _assert_results_match(res, rres, ("groundtruth", "texts"),
                          ("confidence",))
    for k in ("correct", "pred_numbers", "pred_templates"):
        assert [v for v, c in zip(res[k], clear) if c] == \
            [v for v, c in zip(rres[k], clear) if c], k
    metrics = port.compute_metrics(res)
    assert metrics == ref.compute_metrics(res)
    if clear.all():
        _assert_results_match(metrics, ref.compute_metrics(rres),
                              ("accuracy", "argmax_accuracy",
                               "total_samples", "correct",
                               "high_confidence_accuracy",
                               "per_number_accuracy"), ("avg_confidence",))
    port.save_results(res, metrics, str(tmp_path))
    with open(tmp_path / "countbench_metrics.json") as f:
        assert json.load(f)["total_samples"] == 11
    blob = np.load(tmp_path / "countbench_results.npy",
                   allow_pickle=True).item()
    assert blob["results"] == res and blob["metrics"] == metrics
    assert os.path.exists(tmp_path / "countbench_confusion.png")


def test_countbench_debug_dir(weights, scorers, cb_samples, tmp_path):
    ev = tcb.CountBenchEvaluator(weights[1], CFG, tokenizer=TOK,
                                 device="cpu", batch_size=4,
                                 debug_dir=str(tmp_path),
                                 samples_of_interest=[0, 5])
    ev.scorer = scorers[0]
    ev.evaluate_dataset(cb_samples)
    assert sorted(os.listdir(tmp_path)) == [
        "sample_0_image.png", "sample_0_probs.png",
        "sample_5_image.png", "sample_5_probs.png"]


def test_vlmsblind_run_all_tasks_matches_jax(weights, scorers, tmp_path):
    params, sd = weights
    samples = tfix.make_vlmsblind_fixture(str(tmp_path / "fix"), per_task=2,
                                          image_size=64, seed=1)
    for s in samples:
        s["image"] = s["image_path"]
    img = samples[0]["image"]
    samples += [{"image": img, "task": "Nested Squares", "groundtruth": 9},
                {"image": img, "task": "Counting Grid - Blank Grids",
                 "groundtruth": "2x2"},
                {"image": img, "task": "Circled Letter", "groundtruth": "e"}]
    port = tvb.VLMsBlindEvaluator(sd, CFG, tokenizer=TOK, device="cpu",
                                  batch_size=4)
    ref = jvb.VLMsBlindEvaluator(params, JCFG, tokenizer=JTOK, batch_size=4)
    port.scorer, ref.scorer = scorers
    out, rout = str(tmp_path / "port"), str(tmp_path / "jax")
    metrics = port.run_all_tasks(samples, output_dir=out)
    rmetrics = ref.run_all_tasks(samples, output_dir=rout)
    assert list(metrics) == list(jvb.TASKS)
    assert sorted(os.listdir(out)) == sorted(os.listdir(rout))
    for task in jvb.TASKS:
        _assert_results_match(metrics[task], rmetrics[task],
                              set(rmetrics[task]) - {"avg_confidence"},
                              ("avg_confidence",))
        safe = task.replace(" ", "_").replace("-", "") + "_results.npy"
        a = np.load(os.path.join(out, safe), allow_pickle=True).item()
        b = np.load(os.path.join(rout, safe), allow_pickle=True).item()
        _assert_results_match(a["results"], b["results"],
                              ("correct", "pred_templates", "groundtruth"),
                              ("confidence",))
    assert metrics["Nested Squares"]["total_samples"] == 3
    assert metrics["Circled Letter"]["total_samples"] == 1
    with open(os.path.join(out, "vlmsblind_metrics.json")) as f:
        assert json.load(f) == json.loads(json.dumps(metrics))


def _crop_results_match(got, ref):
    assert len(got["individual_results"]) == len(ref["individual_results"])
    for a, b in zip(got["individual_results"], ref["individual_results"]):
        assert a["category"] == b["category"]
        for cond in tcd.CONDITIONS:
            _assert_results_match(a[cond], b[cond],
                                  ("object_name", "correct", "ground_truth"),
                                  ("positive_score", "negative_score"))
    for cond in tcd.CONDITIONS:
        _assert_results_match(got["aggregate_stats"][cond],
                              ref["aggregate_stats"][cond],
                              ("correct", "accuracy"),
                              ("avg_positive", "avg_negative"))


@pytest.mark.parametrize("mode", ["batched", "serial_debug", "white_square"])
def test_crop_detection_matches_jax(weights, tmp_path, mode):
    params, sd = weights
    kw = dict(batch_size=12, use_white_square=mode == "white_square")
    port = tcd.CropDetectionEvaluator(sd, CFG, tokenizer=TOK, device="cpu",
                                      **kw)
    ref = jcd.CropDetectionEvaluator(params, JCFG, tokenizer=JTOK, **kw)
    dbg = {"port": None, "jax": None}
    if mode == "serial_debug":
        dbg = {k: str(tmp_path / k) for k in dbg}
    # 3 samples in chunks of 2: a full chunk and a short one.
    got = port.run_evaluation(tcd.ProceduralObjectSource(128, seed=5),
                              num_samples=3, debug_dir=dbg["port"])
    want = ref.run_evaluation(jcd.ProceduralObjectSource(128, seed=5),
                              num_samples=3, debug_dir=dbg["jax"])
    _crop_results_match(got, want)
    if mode == "serial_debug":
        dirs = sorted(os.listdir(dbg["port"]))
        assert dirs == sorted(os.listdir(dbg["jax"])) and len(dirs) == 3
        for d in dirs:
            assert sorted(os.listdir(os.path.join(dbg["port"], d))) == [
                "crop_10_positive.png", "crop_5_positive.png",
                "original_positive.png"]
    path = str(tmp_path / "crop.json")
    port.save(got, path)
    with open(path) as f:
        assert json.load(f)["aggregate_stats"] == got["aggregate_stats"]


@pytest.mark.parametrize("debug", [False, True])
def test_crop_detection_raises_a_scorer_failure(weights, tmp_path, debug):
    """A failed scorer call (a kernel's error on the card) ends the sweep;
    only a failed sample draw is logged and drawn again."""
    ev = tcd.CropDetectionEvaluator(weights[1], CFG, tokenizer=TOK,
                                    device="cpu")

    def broken(*args):
        raise RuntimeError("kernel launch failed")

    ev.scorer = broken
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ev.run_evaluation(tcd.ProceduralObjectSource(64, seed=0),
                          num_samples=2,
                          debug_dir=str(tmp_path) if debug else None)

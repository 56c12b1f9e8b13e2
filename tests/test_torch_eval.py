"""The port's numpy evaluation (``vae_tagger_tpu_torch/eval``) against the
JAX package's, which calls scikit-learn: ``MultiLabelEvaluator`` on seeded
and hypothesis-drawn predictions (ties, a class without positives, an
all-positive class, weighted labels), abs <= 1e-12 on every metric;
``find_optimal_threshold`` and ``evaluate_model`` write equal files, also
for labels outside {0, 1} after the int cast, where sklearn's reading (and
its errors) decide; ``python -m vae_tagger_tpu_torch.eval`` end to end on
the CPU, and its ``--use_val_split``."""

import json
import warnings

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from vae_tagger_tpu.eval import metrics as jax_metrics
from vae_tagger_tpu.eval import threshold as jax_threshold
from vae_tagger_tpu_torch.eval import metrics, threshold

TOL = 1e-12  # float64 sums taken in the same order: rounding noise only


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _metrics_pair(y_pred, y_true, y_prob, names=None):
    out = []
    for mod in (metrics, jax_metrics):
        ev = mod.MultiLabelEvaluator(names)
        ev.update(y_pred, y_true, y_prob)
        out.append(ev.compute_metrics())
    return out


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "per_class":
            assert list(got[k]) == list(v)
            for name, row in v.items():
                assert set(got[k][name]) == set(row), name
                for m, x in row.items():
                    assert got[k][name][m] == pytest.approx(x, abs=TOL), \
                        (name, m)
        else:
            assert got[k] == pytest.approx(v, abs=TOL), k


def _case(seed, n=40, c=7, ties=True):
    """Seeded probabilities with ties, a class without positives (column
    1), an all-positive class (column 2) and weighted labels."""
    rng = np.random.default_rng(seed)
    y_prob = rng.uniform(size=(n, c)).astype(np.float32)
    if ties:
        y_prob = (np.round(y_prob * 8) / 8).astype(np.float32)
    y_true = (rng.uniform(size=(n, c)) < 0.35).astype(np.float32)
    y_true *= rng.choice([1.0, 0.8, 0.5], size=(n, c)).astype(np.float32)
    y_true[:, 1] = 0.0
    y_true[:, 2] = 0.9
    return y_prob, y_true


@pytest.mark.parametrize("seed,ties", [(0, True), (1, False), (2, True)])
def test_evaluator_matches_sklearn_on_seeded_cases(seed, ties):
    y_prob, y_true = _case(seed, ties=ties)
    for thr in (0.3, 0.5, 0.95):
        y_pred = (y_prob > thr).astype(np.float32)
        got, want = _metrics_pair(y_pred, y_true, y_prob,
                                  [f"t{i}" for i in range(y_true.shape[1])])
        _assert_metrics_equal(got, want)


@st.composite
def _predictions(draw):
    n = draw(st.integers(2, 24))
    c = draw(st.integers(2, 6))
    levels = draw(st.integers(2, 12))  # few levels: many tied scores
    ints = st.integers(0, levels)
    prob = np.array(draw(st.lists(ints, min_size=n * c, max_size=n * c)),
                    np.float32).reshape(n, c) / levels
    weights = st.sampled_from([0.0, 0.0, 0.5, 0.8, 1.0])
    true = np.array(draw(st.lists(weights, min_size=n * c,
                                  max_size=n * c)), np.float32).reshape(n, c)
    thr = draw(st.sampled_from([0.0, 0.25, 0.5, 0.75, 1.0]))
    return prob, true, thr


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_predictions())
def test_evaluator_matches_sklearn_on_drawn_cases(case):
    y_prob, y_true, thr = case
    y_pred = (y_prob > thr).astype(np.float32)
    got, want = _metrics_pair(y_pred, y_true, y_prob)
    _assert_metrics_equal(got, want)


def test_average_precision_counts_tied_scores_as_one_step():
    """Two tied scores, one positive: AP is the precision at the tie (1/2),
    not 1 (as a per-sample step would give)."""
    from sklearn.metrics import average_precision_score

    y_true = np.array([1.0, 0.0, 0.0])
    y_score = np.array([0.7, 0.7, 0.1])
    assert metrics.binary_average_precision(y_true, y_score) == \
        pytest.approx(0.5, abs=TOL)
    assert average_precision_score(y_true, y_score) == pytest.approx(0.5)


def _threshold_pair(y_prob, y_true, tmp_path):
    names = [f"tag_{i}" for i in range(y_true.shape[1])]
    results = []
    for mod, sub in ((threshold, "port"), (jax_threshold, "jax")):
        out = tmp_path / sub
        res = mod.find_optimal_threshold(None, None, names,
                                         output_dir=str(out),
                                         collected=(y_prob, y_true))
        mets = mod.evaluate_model(None, None, names,
                                  threshold=res["global_threshold"],
                                  output_dir=str(out),
                                  collected=(y_prob, y_true))
        results.append((res, mets, out))
    return results


@pytest.mark.parametrize("seed", [0, 3])
def test_threshold_search_and_evaluation_write_equal_files(tmp_path, seed):
    y_prob, y_true = _case(seed)
    (res, mets, out), (jres, jmets, jout) = _threshold_pair(
        y_prob, y_true, tmp_path)
    assert res == jres
    assert json.loads((out / "optimal_thresholds.json").read_text()) == \
        json.loads((jout / "optimal_thresholds.json").read_text())
    _assert_metrics_equal(mets, jmets)
    got = json.loads((out / "evaluation_results_overall.json").read_text())
    want = json.loads((jout / "evaluation_results_overall.json").read_text())
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=TOL), k
    assert (out / "evaluation_results.csv").read_text() == \
        (jout / "evaluation_results.csv").read_text()


def test_per_class_csv_without_pandas_is_the_same_text(tmp_path,
                                                       monkeypatch):
    import builtins

    y_prob, y_true = _case(4)
    ev = metrics.MultiLabelEvaluator([f"t{i}" for i in range(7)])
    ev.update((y_prob > 0.5).astype(np.float32), y_true, y_prob)
    per_class = ev.compute_metrics()["per_class"]
    metrics.write_per_class_csv(per_class, str(tmp_path / "pandas.csv"))
    real_import = builtins.__import__

    def no_pandas(name, *args, **kwargs):
        if name == "pandas":
            raise ImportError("no pandas")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    metrics.write_per_class_csv(per_class, str(tmp_path / "plain.csv"))
    assert (tmp_path / "plain.csv").read_text() == \
        (tmp_path / "pandas.csv").read_text()


@pytest.mark.parametrize("labels", [
    "twos_with_ones",      # {0, 1, 2}: sklearn refuses the matrix
    "twos_only",           # {0, 2}: an indicator matrix (nonzero = positive)
    "negative",            # -1.5 -> -1: {-1, 0}
    "one_and_two",         # {1, 2} in a column
])
def test_labels_outside_0_1_after_the_cast_follow_sklearn(tmp_path, labels):
    """Weights >= 2 (or <= -1) survive the reference's astype(int); the
    search then takes sklearn's reading, errors included: the port raises
    what the JAX package (sklearn) raises, or writes the same JSON."""
    rng = np.random.default_rng(5)
    n, c = 30, 4
    y_prob = rng.uniform(size=(n, c)).astype(np.float32)
    pos = rng.uniform(size=(n, c)) < 0.4
    y_true = pos.astype(np.float32)
    if labels == "twos_with_ones":
        y_true[0, 0] = 2.5
    elif labels == "twos_only":
        y_true = pos * 2.0
    elif labels == "negative":
        y_true = -1.5 * pos
    elif labels == "one_and_two":
        y_true = np.where(pos, 2.0, 1.0).astype(np.float32)
    names = [f"tag_{i}" for i in range(c)]
    outcomes = []
    for mod, sub in ((threshold, "port"), (jax_threshold, "jax")):
        try:
            res = mod.find_optimal_threshold(
                None, None, names, output_dir=str(tmp_path / sub),
                collected=(y_prob, y_true))
            outcomes.append(("ok", res))
        except ValueError as e:
            outcomes.append(("ValueError", str(e)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("t,p", [
    ([[0, 2], [2, 0], [2, 2]], [[0, 1], [1, 1], [0, 0]]),
    ([[0, 2], [1, 0], [2, 2]], [[0, 1], [1, 1], [0, 0]]),
    ([[1, 2], [2, 1], [1, 1]], [[0, 1], [1, 1], [0, 0]]),
    ([0, 2, 2], [0, 1, 0]), ([0, 2, 2], [0, 0, 0]), ([2, 2], [1, 1]),
    ([1, 2, 2], [1, 1, 1]), ([-1, 0, 1], [1, 1, 0]), ([1, 1], [1, 1])])
def test_sklearn_f1_reading_of_int_labels(t, p):
    from sklearn.metrics import f1_score

    t, p = np.array(t), np.array(p)
    average = "macro" if t.ndim == 2 else "binary"
    try:
        want = ("ok", f1_score(t, p, average=average, zero_division=0))
    except ValueError as e:
        want = ("ValueError", str(e))
    try:
        got = ("ok", threshold._sklearn_f1(t, p, average))
    except ValueError as e:
        got = ("ValueError", str(e))
    assert got[0] == want[0] and (
        got[1] == want[1] if got[0] == "ValueError"
        else got[1] == pytest.approx(want[1], abs=TOL))


def test_collect_predictions_reads_tensors_and_drops_masked_rows():
    batches = [{"labels": np.eye(3, dtype=np.float32)[:2],
                "batch_mask": np.array([True, False])},
               {"labels": np.eye(3, dtype=np.float32)[1:]}]
    probs = iter([torch.tensor([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]]),
                  torch.tensor([[0.7, 0.8, 0.9], [0.0, 0.1, 0.2]])])
    y_prob, y_true = threshold.collect_predictions(lambda b: next(probs),
                                                   batches)
    np.testing.assert_allclose(y_prob, [[0.1, 0.2, 0.3], [0.7, 0.8, 0.9],
                                        [0.0, 0.1, 0.2]], rtol=1e-6)
    np.testing.assert_array_equal(y_true, np.eye(3)[[0, 1, 2]])


# --------------------------------------------------------------------------
# python -m vae_tagger_tpu_torch.eval
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    """A tiny VAE, a head and 10 weighted-tagged PNGs at 32px."""
    from PIL import Image

    from vae_tagger_tpu_torch.core.config import (
        AttentionDecoderConfig,
        default_flux_vae_config,
    )
    from vae_tagger_tpu_torch.io.checkpoints import (
        save_decoder_bin,
        save_vae_pretrained,
    )
    from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from vae_tagger_tpu_torch.models.taggers import (
        AttentionClassificationDecoder,
    )
    from vae_tagger_tpu_torch.nn.blocks import seeded_init_

    root = tmp_path_factory.mktemp("eval")
    cfg = default_flux_vae_config(block_out_channels=(8, 16, 16, 16),
                                  norm_num_groups=4, latent_channels=4)
    save_vae_pretrained(seeded_init_(AutoencoderKL(cfg, with_decoder=True),
                                     0), cfg, str(root / "vae"))
    head = seeded_init_(AttentionClassificationDecoder(
        4, 5, AttentionDecoderConfig(attention_heads=1)), 1)
    save_decoder_bin(head, str(root / "head.bin"))
    tags = [f"t{i}" for i in range(5)]
    (root / "tags.csv").write_text(
        "name,count\n" + "".join(f"{t},1\n" for t in tags))
    (root / "images").mkdir()
    rng = np.random.default_rng(9)
    data = {}
    for i in range(10):
        p = root / "images" / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)
                        ).save(p)
        data[str(p)] = ", ".join(f"{t}:0.8" for t in
                                 rng.choice(tags, 2, replace=False))
    (root / "data.json").write_text(json.dumps(data))
    argv = ["--device", "cpu", "--vae_checkpoint",
            str(root / "vae" / "diffusion_pytorch_model.safetensors"),
            "--vae_config_path", str(root / "vae" / "config.json"),
            "--decoder_checkpoint", str(root / "head.bin"),
            "--json_path", str(root / "data.json"),
            "--tags_csv_path", str(root / "tags.csv"), "--resolution", "32",
            "--batch_size", "4", "--num_workers", "2",
            "--attention_heads", "1"]
    return dict(root=root, argv=argv, data=data)


def _engine_probs(eval_data, keys):
    from vae_tagger_tpu_torch.data.bucketing import load_and_transform_image
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine

    root = eval_data["root"]
    eng = TaggerEngine.load(
        str(root / "vae" / "diffusion_pytorch_model.safetensors"),
        str(root / "head.bin"), str(root / "tags.csv"),
        vae_config_path=str(root / "vae" / "config.json"),
        attention_config={"attention_heads": 1}, device="cpu")
    px = np.stack([load_and_transform_image(k, 32) for k in keys])
    return eng.classify(px)


def test_eval_cli_writes_the_evaluation_files(eval_data):
    """The CLI's metrics equal the JAX evaluate_model (sklearn) applied to
    the engine's probabilities on the same images, at the threshold the
    JAX search finds."""
    from vae_tagger_tpu_torch.data.dataset import TaggedImageDataset
    from vae_tagger_tpu_torch.eval.__main__ import main as eval_main

    out = eval_data["root"] / "out"
    got = eval_main([*eval_data["argv"], "--output_dir", str(out)])
    for f in ("optimal_thresholds.json", "evaluation_results.csv",
              "evaluation_results_overall.json"):
        assert (out / f).exists(), f
    keys = list(eval_data["data"])
    ds = TaggedImageDataset(str(eval_data["root"] / "data.json"),
                            str(eval_data["root"] / "tags.csv"), 32)
    y_prob = _engine_probs(eval_data, keys)
    names = [f"t{i}" for i in range(5)]
    jres = jax_threshold.find_optimal_threshold(
        None, None, names, collected=(y_prob, ds.labels_matrix))
    assert json.loads((out / "optimal_thresholds.json").read_text()) == jres
    jmets = jax_threshold.evaluate_model(
        None, None, names, threshold=jres["global_threshold"],
        collected=(y_prob, ds.labels_matrix))
    assert got["threshold"] == jres["global_threshold"]
    _assert_metrics_equal({k: v for k, v in got.items() if k != "threshold"},
                          jmets)


def test_eval_cli_val_split_and_fixed_threshold(eval_data):
    from vae_tagger_tpu_torch.data.loader import train_val_split
    from vae_tagger_tpu_torch.eval.__main__ import main as eval_main

    out = eval_data["root"] / "val"
    got = eval_main([*eval_data["argv"], "--output_dir", str(out),
                     "--use_val_split", "--seed", "0", "--threshold",
                     "0.4"])
    assert got["threshold"] == 0.4
    assert not (out / "optimal_thresholds.json").exists()
    _, val = train_val_split(10, 0.1, seed=42)  # seed 0 -> 42
    per_class = got["per_class"]
    assert sum(m["support"] for m in per_class.values()) <= 2 * len(val)


def test_eval_cli_refuses_bucketing_and_needs_a_gpu(eval_data, tmp_path):
    """--use_bucketing runs on the CPU since bucketing was ported (the
    36x36 images go to the square bucket of a 32..48 grid); without
    --device cpu the CLI needs a GPU."""
    from vae_tagger_tpu_torch.eval.__main__ import main as eval_main

    got = eval_main([*eval_data["argv"], "--output_dir",
                     str(tmp_path / "bucketed"), "--use_bucketing",
                     "--base_resolution", "32", "--max_resolution", "48",
                     "--bucket_step", "16"])
    assert np.isfinite(got["f1_macro"])
    assert (tmp_path / "bucketed" / "evaluation_results.csv").exists()
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    argv = [a for a in eval_data["argv"] if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        eval_main([*argv, "--output_dir", str(tmp_path)])

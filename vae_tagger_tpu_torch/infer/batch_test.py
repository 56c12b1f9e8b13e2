"""Batch inference check against ground truth (the port's counterpart of
``scripts/batch_inference_test.py``):

    python -m vae_tagger_tpu_torch.infer.batch_test \\
        --vae_checkpoint vae/diffusion_pytorch_model.safetensors \\
        --vae_config_path vae/config.json \\
        --decoder_checkpoint pytorch_model.bin --tags_csv_path tags.csv \\
        --image_dir images --data_json_path data.json [--device cpu]

Tags the first ``--max_images`` ``*.jpg`` of a directory, compares each
image's predicted tag set with its ``data.json`` tags by file name, and
reports the mean set precision, recall, F1 and exact-match rate, written
to ``<output_dir>/batch_test_results.json``.  The engine is loaded once and
the images run in device batches of ``--batch_size``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data.bucketing import load_and_transform_image
from .classify import _format_results


def load_ground_truth(data_json_path) -> dict:
    """image path -> its tag names, from a data.json of weighted tags."""
    with open(data_json_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return {str(Path(p).as_posix()): [part.split(":")[0].strip()
                                      for part in labels.split(",")
                                      if part.strip()]
            for p, labels in data.items()}


def calculate_metrics(predictions: dict, ground_truth: dict) -> dict:
    """Per-image set precision, recall, F1 and exact match, averaged over
    the images found in the ground truth (matched by file name)."""
    by_name = {Path(p).name: tags for p, tags in ground_truth.items()}
    totals = dict(precision=0.0, recall=0.0, f1=0.0, exact=0, n=0)
    detailed = []
    for img_path, pred_data in predictions.items():
        true_tags = by_name.get(Path(img_path).name)
        if true_tags is None:
            print(f"warning: no ground truth for {img_path}")
            continue
        pred_tags = [item["tag"] for item in pred_data["predicted_tags"]]
        true_set, pred_set = set(true_tags), set(pred_tags)
        inter = true_set & pred_set
        precision = len(inter) / len(pred_set) if pred_set else 0.0
        recall = len(inter) / len(true_set) if true_set else 1.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
        exact = int(true_set == pred_set)
        detailed.append({"image": Path(img_path).name,
                         "true_tags": true_tags, "pred_tags": pred_tags,
                         "precision": precision, "recall": recall,
                         "f1": f1, "exact_match": exact})
        totals["precision"] += precision
        totals["recall"] += recall
        totals["f1"] += f1
        totals["exact"] += exact
        totals["n"] += 1
    n = max(totals["n"], 1)
    return {"avg_precision": totals["precision"] / n,
            "avg_recall": totals["recall"] / n,
            "avg_f1": totals["f1"] / n,
            "exact_match_rate": totals["exact"] / n,
            "total_images": totals["n"],
            "detailed_results": detailed}


def classify_paths(engine, paths, resolution: int, batch_size: int,
                   threshold: float) -> dict:
    """path -> its ``classification_results.json`` entry; the images run
    in device batches, one batch in flight while the next decodes."""
    predictions, pending = {}, None
    for start in range(0, len(paths), batch_size):
        chunk = paths[start:start + batch_size]
        pixels = np.stack([load_and_transform_image(str(p),
                                                    resolution=resolution)
                           for p in chunk])
        dispatched = (chunk, engine.classify_async(pixels)[0])
        if pending is not None:
            _finish(engine, *pending, threshold, predictions)
        pending = dispatched
    if pending is not None:
        _finish(engine, *pending, threshold, predictions)
    return predictions


def _finish(engine, chunk, device_probs, threshold, predictions):
    for path, probs in zip(chunk, device_probs.cpu().numpy()):
        predictions[str(path)] = _format_results(engine.tag_names, probs,
                                                 threshold)
        print(f"{Path(path).name}: ok")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.infer.batch_test",
        description="batch inference test")
    p.add_argument("--vae_checkpoint", type=str,
                   default="full_output/best_vae/"
                   "diffusion_pytorch_model.safetensors")
    p.add_argument("--vae_config_path", type=str,
                   default="full_output/best_vae/config.json")
    p.add_argument("--decoder_checkpoint", type=str,
                   default="full_output/best_decoder/pytorch_model.bin")
    p.add_argument("--tags_csv_path", type=str,
                   default="test_dataset/tags.csv")
    p.add_argument("--image_dir", type=str, default="test_dataset/images")
    p.add_argument("--data_json_path", type=str,
                   default="test_dataset/data.json")
    p.add_argument("--output_dir", type=str,
                   default="batch_inference_results")
    p.add_argument("--max_images", type=int, default=10)
    p.add_argument("--confidence_threshold", type=float, default=0.3)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--mixed_precision", type=str, default=None,
                   help="no|fp16|bf16 (fp16 and bf16 both run bf16)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    from .engine import TaggerEngine

    args = build_parser().parse_args(argv)
    print("batch inference test starting")
    paths = sorted(Path(args.image_dir).glob("*.jpg"))[:args.max_images]
    if not paths:
        print(f"no .jpg images in {args.image_dir}")
        return {}
    engine = TaggerEngine.load(
        vae_checkpoint=args.vae_checkpoint,
        decoder_checkpoint=args.decoder_checkpoint,
        tags_csv_path=args.tags_csv_path,
        vae_config_path=args.vae_config_path,
        mixed_precision=args.mixed_precision, device=args.device)
    predictions = classify_paths(engine, paths, args.resolution,
                                 args.batch_size, args.confidence_threshold)
    metrics = calculate_metrics(predictions,
                                load_ground_truth(args.data_json_path))

    print("\noverall metrics")
    print(f"avg precision: {metrics['avg_precision']:.4f}")
    print(f"avg recall: {metrics['avg_recall']:.4f}")
    print(f"avg F1: {metrics['avg_f1']:.4f}")
    print(f"exact match rate: {metrics['exact_match_rate']:.4f}")
    print(f"images tested: {metrics['total_images']}")
    print("\ndetailed results")
    for r in metrics["detailed_results"]:
        print(f"{r['image']}:")
        print(f"  true: {r['true_tags']}")
        print(f"  pred: {r['pred_tags']}")
        print(f"  P: {r['precision']:.3f}, R: {r['recall']:.3f}, "
              f"F1: {r['f1']:.3f}")

    output_file = Path(args.output_dir) / "batch_test_results.json"
    output_file.parent.mkdir(parents=True, exist_ok=True)
    with open(output_file, "w", encoding="utf-8") as f:
        json.dump(metrics, f, indent=2, ensure_ascii=False)
    print(f"results saved to: {output_file}")
    return metrics


if __name__ == "__main__":
    main()

"""Batched image tagging (counterpart of ``vae_tagger_tpu/infer/classify.py``).

Writes ``classification_results.json`` in the reference's schema: per
image, the tags at or above the threshold in descending confidence, their
count, the max confidence and the mean of the top-5 confidences.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np

from ..data.paths import get_image_paths
from ..utils.pipelining import OneInFlight
from ..utils.profiling import ThroughputMeter
from .engine import TaggerEngine
from .pipeline import iter_image_batches, pad_tail_rows


def _format_results(tag_names: List[str], probs: np.ndarray,
                    threshold: float) -> dict:
    order = np.argsort(-probs, kind="stable")
    sorted_probs = probs[order]
    predicted = []
    for conf, idx in zip(sorted_probs, order):
        conf = float(conf)
        if conf >= threshold:
            predicted.append({
                "tag": tag_names[int(idx)],
                "confidence": float(f"{conf:.4f}"),
            })
    return {
        "predicted_tags": predicted,
        "total_tags_above_threshold": len(predicted),
        "max_confidence": float(f"{float(sorted_probs[0]):.4f}"),
        "avg_confidence_top5": float(
            f"{float(sorted_probs[:5].sum()) / 5:.4f}"),
    }


def infer_and_classify(engine: TaggerEngine, image_path: str,
                       output_dir: str = "inference_output",
                       resolution: int = 1024,
                       confidence_threshold: float = 0.5,
                       batch_size: int = 8,
                       output_name: str = "classification_results.json",
                       verbose: bool = True,
                       num_workers: int = 4,
                       prefetch_factor: int = 2,
                       transfer_format: str = "rgb") -> dict:
    """Tag a file or directory of images; writes the results JSON.

    Decode runs on a thread pool a batch ahead of the device, and one batch
    stays in flight on the device while the previous one is formatted.
    ``transfer_format="yuv420"`` ships planar 4:2:0 to the device (half of
    RGB's bytes), which turns it back into RGB; tags match the RGB path's
    within the chroma subsampling's noise."""
    image_paths = get_image_paths(image_path)
    if not image_paths:
        print("no image files found; check the path")
        return {}

    results = {}
    processed, errors = 0, 0
    meter = ThroughputMeter()

    def finalize(paths, device_probs, n):
        nonlocal processed
        probs = device_probs.cpu().numpy()[:n]
        for path, p in zip(paths, probs):
            results[path] = _format_results(engine.tag_names, p,
                                            confidence_threshold)
        processed += n
        meter.update(n)
        if verbose and processed % 100 < batch_size:
            print(f"processed {processed}/{len(image_paths)} images "
                  f"({errors} errors skipped)")

    pipeline = OneInFlight(finalize)
    classify_async = (engine.classify_yuv_async
                      if transfer_format == "yuv420"
                      else engine.classify_async)
    for evt in iter_image_batches(image_paths, resolution, batch_size,
                                  num_workers, prefetch_factor,
                                  pixel_format=transfer_format):
        if evt[0] == "error":
            errors += 1
            print(f"skipping image {evt[1]}: {evt[2]}")
            continue
        _, batch_paths, block = evt
        block = pad_tail_rows(block, batch_size)
        device_probs, _ = (classify_async(*block) if isinstance(block, tuple)
                           else classify_async(block))
        pipeline.submit(batch_paths, device_probs, len(batch_paths))
    pipeline.flush()

    if verbose:
        print(f"done -- ok: {processed}, failed: {errors}, "
              f"total: {len(image_paths)}, {meter.report()}")

    output_path = Path(output_dir) / output_name
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=4, ensure_ascii=False)
    if verbose:
        print(f"classification results saved to: {output_path}")
    return results

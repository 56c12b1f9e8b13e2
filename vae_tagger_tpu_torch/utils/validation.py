"""Dataset linter and resolution analyzer (the port's copy of
``vae_tagger_tpu/utils/validation.py`` and of ``scripts/validate_data.py``
and ``scripts/analyze_resolutions.py``):

    python -m vae_tagger_tpu_torch.utils.validation validate_data \\
        --json_path data.json --tags_csv_path tags.csv [--fix]
    python -m vae_tagger_tpu_torch.utils.validation analyze_resolutions \\
        --json_path data.json

- :func:`validate_dataset`: missing images, empty labels, tags unknown to
  the CSV, top-tag counts; four JSON reports and, with ``fix``, a cleaned
  ``data.cleaned.json``;
- :func:`analyze_image_resolutions`: the size and aspect distribution, a
  crop recommendation, and a training resolution (sqrt of the mean area,
  floored to a multiple of 64).
"""

from __future__ import annotations

import argparse
import json
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict

from ..data.dataset import load_tag_names


def validate_dataset(json_path: str, tags_csv_path: str,
                     output_dir: str = "data_validation",
                     fix: bool = False) -> Dict:
    json_path = Path(json_path)
    tags_csv_path = Path(tags_csv_path)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if not json_path.exists():
        raise FileNotFoundError(f"data JSON not found: {json_path}")
    if not tags_csv_path.exists():
        raise FileNotFoundError(f"tags CSV not found: {tags_csv_path}")

    with open(json_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    valid_tags = set(load_tag_names(str(tags_csv_path)))

    def parse_names(tag_str: str):
        names = []
        for chunk in (tag_str or "").split(","):
            chunk = chunk.strip()
            if not chunk:
                continue
            names.append(chunk.split(":", 1)[0].strip() if ":" in chunk
                         else chunk)
        return names

    missing, empty, unknown_by_image = [], [], {}
    tag_counter: Counter = Counter()
    for i, (img_path, tag_str) in enumerate(data.items()):
        if not Path(img_path).exists():
            missing.append(img_path)
            continue
        names = parse_names(tag_str)
        if not names:
            empty.append(img_path)
            continue
        unknown = [t for t in names if t not in valid_tags]
        if unknown:
            unknown_by_image[img_path] = unknown
        tag_counter.update(t for t in names if t in valid_tags)
        if (i + 1) % 100 == 0:
            print(f"checked {i + 1}/{len(data)}")

    report = {
        "total_images": len(data),
        "existing_images": len(data) - len(missing),
        "missing_images": len(missing),
        "empty_label_images": len(empty),
        "images_with_unknown_tags": len(unknown_by_image),
        "top_tags": tag_counter.most_common(50),
    }
    for name, payload in [("summary.json", report),
                          ("missing_images.json", missing),
                          ("empty_label_images.json", empty),
                          ("unknown_tags_by_image.json", unknown_by_image)]:
        (out / name).write_text(
            json.dumps(payload, indent=2, ensure_ascii=False),
            encoding="utf-8")

    print("dataset validation complete:")
    for k in ("total_images", "existing_images", "missing_images",
              "empty_label_images", "images_with_unknown_tags"):
        print(f"  {k}: {report[k]}")
    print(f"  reports saved to: {out}")

    if fix:
        missing_set = set(missing)
        fixed = {}
        for img_path, tag_str in data.items():
            if img_path in missing_set:
                continue
            kept = []
            for chunk in (tag_str or "").split(","):
                chunk = chunk.strip()
                if not chunk:
                    continue
                if ":" in chunk:
                    name, score = (s.strip() for s in chunk.split(":", 1))
                else:
                    name, score = chunk, "1.0"
                if name in valid_tags:
                    kept.append(f"{name}:{score}")
            if kept:
                fixed[img_path] = ", ".join(kept)
        fixed_path = out / "data.cleaned.json"
        fixed_path.write_text(json.dumps(fixed, indent=2, ensure_ascii=False),
                              encoding="utf-8")
        print(f"cleaned dataset written to: {fixed_path}")
    return report


def analyze_image_resolutions(json_path: str,
                              output_dir: str = "resolution_analysis") -> Dict:
    from PIL import Image

    with open(json_path, "r", encoding="utf-8") as f:
        data = json.load(f)

    resolutions, aspect_ratios = [], []
    resolution_counts: Dict[str, int] = defaultdict(int)
    aspect_counts: Dict[float, int] = defaultdict(int)
    for i, image_path in enumerate(data):
        try:
            if not Path(image_path).exists():
                print(f"image missing: {image_path}")
                continue
            with Image.open(image_path) as img:  # header-only read
                w, h = img.size
            resolutions.append((w, h))
            ratio = round(w / h, 2)
            aspect_ratios.append(ratio)
            resolution_counts[f"{w}x{h}"] += 1
            aspect_counts[ratio] += 1
            if (i + 1) % 100 == 0:
                print(f"analyzed {i + 1}/{len(data)} images")
        except Exception as e:
            print(f"could not read image {image_path}: {e}")

    if not resolutions:
        print("no readable images")
        return {}

    print("\nbasic statistics:")
    print(f"total images: {len(resolutions)}")
    print(f"distinct resolutions: {len(resolution_counts)}")
    print(f"distinct aspect ratios: {len(aspect_counts)}")

    print("\nmost common resolutions (top 10):")
    for res, count in sorted(resolution_counts.items(),
                             key=lambda x: x[1], reverse=True)[:10]:
        print(f"  {res}: {count} ({100.0 * count / len(resolutions):.1f}%)")

    print("\nmost common aspect ratios (top 10):")
    for ratio, count in sorted(aspect_counts.items(),
                               key=lambda x: x[1], reverse=True)[:10]:
        pct = 100.0 * count / len(aspect_ratios)
        if ratio == 1.0:
            print(f"  1:1 (square): {count} ({pct:.1f}%)")
        elif ratio > 1:
            print(f"  {ratio}:1 (landscape): {count} ({pct:.1f}%)")
        else:
            print(f"  1:{1 / ratio:.2f} (portrait): {count} ({pct:.1f}%)")

    widths = [r[0] for r in resolutions]
    heights = [r[1] for r in resolutions]
    print("\nsize ranges:")
    print(f"width:  {min(widths)} - {max(widths)} "
          f"(mean {sum(widths) // len(widths)})")
    print(f"height: {min(heights)} - {max(heights)} "
          f"(mean {sum(heights) // len(heights)})")

    square_ratio = aspect_counts.get(1.0, 0) / len(aspect_ratios)
    print("\nrecommended preprocessing:")
    if square_ratio > 0.7:
        print("mostly square images — plain 'resize' is fine")
    elif square_ratio > 0.3:
        print("mixed aspect ratios — 'center_crop' recommended")
    else:
        print("widely varying aspect ratios — consider center_crop / pad / "
              "resize_shorter (or bucketing, --use_bucketing)")

    avg_area = sum(w * h for w, h in resolutions) / len(resolutions)
    suggested = int((avg_area ** 0.5) // 64 * 64)
    print(f"\nsuggested training resolution (sqrt of mean area, /64): "
          f"{suggested}x{suggested}")
    print("common choices: 512x512 (fast) or 1024x1024 (quality)")

    return {
        "resolutions": resolutions,
        "aspect_ratios": aspect_ratios,
        "resolution_counts": dict(resolution_counts),
        "aspect_ratio_counts": dict(aspect_counts),
        "suggested_resolution": suggested,
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m vae_tagger_tpu_torch.utils.validation",
        description="Validate a dataset or analyze its image resolutions.")
    sub = p.add_subparsers(dest="command", required=True)
    v = sub.add_parser("validate_data",
                       help="check data.json against tags.csv and disk")
    v.add_argument("--json_path", type=str, required=True)
    v.add_argument("--tags_csv_path", type=str, required=True,
                   help="tags CSV (must contain a 'name' column)")
    v.add_argument("--output_dir", type=str, default="data_validation")
    v.add_argument("--fix", action="store_true",
                   help="write data.cleaned.json (drops missing images and "
                   "unknown tags)")
    a = sub.add_parser("analyze_resolutions",
                       help="the image size and aspect distribution")
    a.add_argument("--json_path", type=str, required=True)
    a.add_argument("--output_dir", type=str, default="resolution_analysis")
    args = p.parse_args(argv)
    if args.command == "validate_data":
        return validate_dataset(args.json_path, args.tags_csv_path,
                                args.output_dir, args.fix)
    result = analyze_image_resolutions(args.json_path, args.output_dir)
    print("\nanalysis complete!")
    return result


if __name__ == "__main__":
    main()

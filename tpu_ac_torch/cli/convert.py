"""Checkpoint conversion and validation CLI (port of ``tpu_ac.cli.convert``
for every registry name).

Takes a released torch ``.pth`` (a DINO hub file, or a full DINO training
checkpoint with ``--checkpoint_key teacher``), converts it to a params
dict, checks its keys and shapes against the backbone, and installs it in
the checkpoint cache, where ``load_backbone(name)`` of either package finds
it:

    python -m tpu_ac_torch.cli.convert dino_vitbase8_pretrain.pth \\
        --backbone dino_vitbase8 --verify --install

``--verify`` diffs the checkpoint against the frozen manifest
(``tpu_ac_torch/models/manifests.json``) and exits non-zero on a missing
or misshaped tensor, before anything is installed; extra tensors (a
classifier head) are reported and ignored.  ``--install`` writes the
converted flat state_dict (sub-dict selected, prefixes stripped) to
``--cache_dir`` under the spec's filename: the default dir and the format
are ``tpu_ac``'s.  ``--update_manifests`` (no checkpoint needed)
regenerates the frozen manifests from the architectures.
"""

from __future__ import annotations

import argparse
import os
import sys

from tpu_ac_torch.models.convert import (
    load_torch_checkpoint,
    params_to_torch_state_dict,
    validate_params_against_backbone,
)
from tpu_ac_torch.models.registry import BACKBONE_CONFIGS


def _print_report(report: dict) -> None:
    for kind in ("missing", "unexpected", "shape_mismatch"):
        vals = report[kind]
        if vals:
            print(f"  {kind} ({len(vals)}): {vals[:8]}"
                  f"{' ...' if len(vals) > 8 else ''}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("tpu_ac_torch checkpoint converter")
    p.add_argument("checkpoint", nargs="?",
                   help="path to the torch .pth file")
    p.add_argument("--backbone", choices=sorted(BACKBONE_CONFIGS))
    p.add_argument("--checkpoint_key", default=None,
                   help="sub-dict key, e.g. 'teacher' for DINO training "
                        "checkpoints")
    p.add_argument("--install", action="store_true",
                   help="write the converted state_dict into the checkpoint "
                        "cache under the filename load_backbone expects")
    p.add_argument("--verify", action="store_true",
                   help="diff the checkpoint against the frozen per-model "
                        "manifest; non-zero exit on mismatch")
    p.add_argument("--update_manifests", nargs="*", metavar="NAME",
                   default=None,
                   help="regenerate tpu_ac_torch/models/manifests.json and "
                        "port_manifests.json (all built-in and port-only "
                        "names, or just the listed ones)")
    p.add_argument("--cache_dir",
                   default=os.path.expanduser("~/.cache/tpu_ac/checkpoints"))
    args = p.parse_args(argv)

    if args.update_manifests is not None:
        from tpu_ac_torch.models import manifest
        from tpu_ac_torch.models.registry import (
            BUILTIN_BACKBONES,
            PORT_BACKBONES,
        )

        names = args.update_manifests or None
        for path, own in ((manifest.MANIFEST_PATH, BUILTIN_BACKBONES),
                          (manifest.PORT_MANIFEST_PATH, PORT_BACKBONES)):
            pick = sorted(own) if names is None else \
                [n for n in names if n in own]
            if not pick:
                continue
            manifests = manifest.load_manifests(path) if names else {}
            manifests.update(manifest.generate_all(pick))
            manifest.save_manifests(manifests, path)
            print(f"manifests written: {len(manifests)} models -> {path}")
        return {}

    if args.checkpoint is None or args.backbone is None:
        p.error("checkpoint and --backbone are required "
                "(unless --update_manifests)")

    params = load_torch_checkpoint(args.checkpoint, args.checkpoint_key)

    if args.verify:
        from tpu_ac_torch.models import manifest

        report = manifest.verify_checkpoint(params, args.backbone)
        # missing or misshaped tensors break the conversion; extra ones
        # (heads the feature extractor never builds) are only unused
        bad = report["missing"] or report["shape_mismatch"]
        print(f"{args.checkpoint}: {len(params)} tensors vs frozen manifest "
              f"'{args.backbone}'")
        _print_report(report)
        if bad:
            print("FAIL — checkpoint does not match the frozen manifest")
            sys.exit(1)
        print("VERIFIED — checkpoint covers the frozen manifest"
              + (" (extra unused tensors ignored)" if report["unexpected"]
                 else " exactly"))

    report = validate_params_against_backbone(params, args.backbone)
    n_ok = len(params) - len(report["unexpected"])
    print(f"{args.checkpoint}: {len(params)} tensors, {n_ok} map onto "
          f"'{args.backbone}'")
    _print_report(report)
    ok = not report["missing"] and not report["shape_mismatch"]
    print("OK — checkpoint fully covers the backbone" if ok
          else "WARNING — conversion incomplete (see above)")

    if args.install:
        if not ok:
            print("NOT installed — the conversion is incomplete; fix the "
                  "checkpoint/backbone pairing first")
            sys.exit(1)
        import torch

        spec = BACKBONE_CONFIGS[args.backbone]
        os.makedirs(args.cache_dir, exist_ok=True)
        dest = os.path.join(args.cache_dir, spec.checkpoint)
        torch.save(params_to_torch_state_dict(params), dest)
        print(f"installed -> {dest}")
    return report


if __name__ == "__main__":
    main()

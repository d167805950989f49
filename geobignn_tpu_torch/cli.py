"""Command-line entry points.

Counterpart of geobignn_tpu/cli.py: the reference's invocation surface
(run_py*.bat: `python train_dual.py --data_type=Synthetic --gpu=0 --flag=x
--lr_sch=auto ...`) as subcommands of one module:

    python -m geobignn_tpu_torch train    --data_type=Synthetic --flag=x [--k=v ...]
    python -m geobignn_tpu_torch infer    --run_dir=log/.../timestamp [--data_dir=...]
    python -m geobignn_tpu_torch eval     --result_dir=... --original_dir=...
    python -m geobignn_tpu_torch campaign --data_type=Synthetic [--k=v ...]

Every subcommand runs on the GPU unless `--device=cpu` is given.  Unknown
`--key=value` pairs of `train` and `campaign` are applied onto the Config
(typed via json parsing); a key the Config does not have exits with the
list of valid keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from geobignn_tpu_torch.config import Config


def _apply_extras(cfg_dict: dict, extras: list[str]) -> dict:
    known = {f.name for f in dataclasses.fields(Config)}
    for arg in extras:
        if not arg.startswith("--") or "=" not in arg:
            raise SystemExit(f"unrecognized argument: {arg}")
        k, v = arg[2:].split("=", 1)
        if k not in known:
            raise SystemExit(
                f"unknown config key '--{k}' (typo?); valid keys: "
                + ", ".join(sorted(known))
            )
        try:
            cfg_dict[k] = json.loads(v)
        except json.JSONDecodeError:
            cfg_dict[k] = v
    return cfg_dict


def _config_of(args, extras) -> Config:
    base = {}
    if args.config:
        with open(args.config) as f:
            base = json.load(f)
    base.update(data_type=args.data_type, flag=args.flag, dataset_dir=args.dataset_dir)
    return Config.from_dict(_apply_extras(base, extras))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser(prog="geobignn_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train")
    p_inf = sub.add_parser("infer")
    p_ev = sub.add_parser("eval")
    # one-command accuracy campaign at the reference protocol: train on
    # <dataset_dir>/<data_type>/train (train_list.txt manifest), denoise the
    # manifest-selected test split, write ErrorInfo_h.txt +
    # campaign_summary.json
    p_cmp = sub.add_parser(
        "campaign",
        help="train + test-split inference + corpus eval in one command "
             "on a reference-layout dataset dir",
    )
    for p, flag in ((p_train, "run"), (p_cmp, "campaign")):
        p.add_argument("--data_type", required=True)
        p.add_argument("--flag", default=flag)
        p.add_argument("--dataset_dir", default="dataset")
        p.add_argument("--config", default=None, help="JSON config file")

    p_inf.add_argument("--run_dir", required=True)
    p_inf.add_argument("--data_dir", default=None)
    p_inf.add_argument("--dataset_root", default=None)
    p_inf.add_argument("--sub_size", type=int, default=None)
    p_inf.add_argument("--halo_parts", type=int, default=None,
                       help="node-partition each mesh over this many devices "
                       "(not ported yet: refused)")
    p_inf.add_argument("--halo_banded", action="store_true",
                       help="banded kernels in the halo convs (not ported yet: refused)")

    p_ev.add_argument("--result_dir", required=True)
    p_ev.add_argument("--original_dir", required=True)

    for p in (p_train, p_inf, p_ev, p_cmp):
        p.add_argument("--device", default=None,
                       help="cuda (the default; fails without a GPU) or cpu")

    args, extras = parser.parse_known_args(argv)

    from geobignn_tpu_torch.infer.evaluate import eval_denoising_result
    from geobignn_tpu_torch.infer.predict import predict_dir
    from geobignn_tpu_torch.train.trainer import train

    if args.cmd == "train":
        cfg = _config_of(args, extras)
        run_dir = train(cfg, device=args.device)
        predict_dir(run_dir, dataset_root=cfg.dataset_dir, device=args.device)
    elif args.cmd == "infer":
        predict_dir(args.run_dir, args.data_dir, args.dataset_root, args.sub_size,
                    halo_parts=args.halo_parts, halo_banded=args.halo_banded,
                    device=args.device)
    elif args.cmd == "eval":
        eval_denoising_result(args.result_dir, args.original_dir, device=args.device)
    elif args.cmd == "campaign":
        cfg = _config_of(args, extras)
        run_dir = train(cfg, device=args.device)
        rep = predict_dir(run_dir, dataset_root=cfg.dataset_dir, device=args.device)
        test_dir = os.path.join(cfg.dataset_dir, cfg.data_type, "test")
        ev = eval_denoising_result(os.path.join(test_dir, f"result_{cfg.flag}"),
                                   os.path.join(test_dir, "original"),
                                   device=args.device)
        summary = dict(run_dir=run_dir, **(rep or {}))
        if isinstance(ev, dict):
            summary["corpus"] = ev.get("corpus")
            summary["eval_rows"] = ev.get("rows")
        out = os.path.join(run_dir, "campaign_summary.json")
        with open(out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"campaign summary -> {out}")
        return summary


if __name__ == "__main__":
    main()

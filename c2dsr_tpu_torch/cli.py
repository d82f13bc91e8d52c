"""Command-line entry point of the port's experiments.

    python -m c2dsr_tpu_torch.cli --synthetic 2000 --n_epoch 1 [--device cpu]

Flag-compatible with ``c2dsr_tpu/cli.py`` (and so with the reference CLI,
main.py:15-66): the same names, defaults and types, plus ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions).
``--synthetic N`` runs on N synthetic users instead of the raw datasets.
Flags that ask for what the port cannot do yet, a mesh or several
processes, raise with the ROADMAP.md item that brings them; none is
ignored.  Batch-sparse propagation has no flag here, as in the JAX CLI:
``Experiment(cfg.with_(batch_sparse_gnn=True), ...)`` reaches it.
"""

from __future__ import annotations

import argparse
import os
from os.path import join

_DISTRIBUTED = ("the port runs one process on one device; `parallel/` on "
                "torch.distributed is ROADMAP.md §A item 2")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="C2DSR (PyTorch + CUDA port)")
    # Experiment
    p.add_argument("--data", type=str, default="fk",
                   help="fk: Food-Kitchen | mb: Movie-Book | "
                        "ee: Entertainment-Education")
    p.add_argument("--len_rec", type=int, default=10)
    # Data
    p.add_argument("--use_raw", action="store_true",
                   help="re-preprocess from raw text even if an npz cache "
                        "exists (the cache is rewritten)")
    p.add_argument("--n_neg_sample", type=int, default=999)
    # Model
    p.add_argument("--d_latent", type=int, default=128)
    p.add_argument("--shared_item_embed", action="store_true")
    p.add_argument("--d_bias", action="store_true")
    # GNN
    p.add_argument("--n_gnn", type=int, default=1)
    p.add_argument("--dropout_gnn", type=float, default=0.2)
    # Transformer
    p.add_argument("--n_attn", type=int, default=1)
    p.add_argument("--n_head", type=int, default=1)
    p.add_argument("--dropout_attn", type=float, default=0.2)
    p.add_argument("--norm_first", action="store_true")
    # Optimizer
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--l2", type=float, default=5e-4)
    p.add_argument("--lr_gamma", type=float, default=0.5)
    p.add_argument("--lr_step", type=int, default=10)
    p.add_argument("--max_grad_norm", type=float, default=5.0)
    p.add_argument("--apply_grad_clip", action="store_true",
                   help="actually apply grad clipping (the reference "
                        "declares the flag but never applies it)")
    p.add_argument("--lambda_loss", type=float, default=0.7)
    # Training
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--n_epoch", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--batch_size_eval", type=int, default=2048)
    p.add_argument("--es_patience", type=int, default=10)
    # --- build flags ---------------------------------------------------------
    p.add_argument("--eval_mode", choices=("sampled", "full"),
                   default="sampled")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="> 1 is not supported yet (ROADMAP.md)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="> 1 is not supported yet (ROADMAP.md)")
    p.add_argument("--compute_dtype", default="auto",
                   choices=("auto", "float32", "bfloat16"),
                   help="activation/matmul dtype; auto = float32 in the "
                        "port, whose kernels take f32 (params always f32)")
    p.add_argument("--path_raw", type=str, default=None,
                   help="override raw data dir (default: data/raw/<Dataset>)")
    p.add_argument("--path_data", type=str, default=None,
                   help="processed-cache dir (default: data/<Dataset>)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint dir (save-on-best; see --resume); "
                        "torch.save files, not the JAX package's")
    p.add_argument("--resume", action="store_true",
                   help="resume from --ckpt if a checkpoint exists there "
                        "(restores params/opt-state/step and the "
                        "best-validation bookkeeping)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the first training "
                        "epoch to this directory")
    p.add_argument("--debug_nans", action="store_true",
                   help="enable autograd anomaly detection and fail fast on "
                        "non-finite losses")
    p.add_argument("--distributed", action="store_true",
                   help="not supported yet (ROADMAP.md)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="not supported yet (ROADMAP.md)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="not supported yet (ROADMAP.md)")
    p.add_argument("--process_id", type=int, default=None,
                   help="not supported yet (ROADMAP.md)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N_USERS",
                   help="run on N synthetic users instead of raw data")
    p.add_argument("--bug_inverted_padding_mask", action="store_true")
    p.add_argument("--bug_truncated_b_neg_pool", action="store_true")
    p.add_argument("--bug_epoch_grad_accum", action="store_true",
                   help="reproduce the reference's epoch-scope zero_grad "
                        "(trainer.py:42): gradients accumulate across all "
                        "batches of an epoch")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels, default) or cpu (their plain "
                        "versions)")
    return p


def _refuse_unsupported(args) -> None:
    """Raise for every flag that asks for a mesh or several processes."""
    asked = [f"--{name} {getattr(args, name)}"
             for name in ("mesh_data", "mesh_model") if getattr(args, name) > 1]
    if args.distributed:
        asked.append("--distributed")
    asked += [f"--{name} {getattr(args, name)}"
              for name in ("coordinator_address", "num_processes",
                           "process_id") if getattr(args, name) is not None]
    if asked:
        raise NotImplementedError(f"{', '.join(asked)}: {_DISTRIBUTED}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unsupported(args)

    import torch

    from c2dsr_tpu_torch.config import Config, DataSpec, MAPPING_DATASET
    from c2dsr_tpu_torch.data import preprocess, raw, synthetic
    from c2dsr_tpu_torch.graph import build
    from c2dsr_tpu_torch.model import c2dsr
    from c2dsr_tpu_torch.noter import Noter
    from c2dsr_tpu_torch.ops import backend, spmm
    from c2dsr_tpu_torch.train.loop import Experiment

    device = backend.resolve_device(args.device)
    cfg_kw = {k: v for k, v in vars(args).items()
              if k in Config.__dataclass_fields__}
    cfg = Config(**cfg_kw)
    cfg = cfg.with_(len_max=cfg.resolved_len_max())
    dataset = MAPPING_DATASET[cfg.data]

    if args.synthetic:
        spec = DataSpec(n_item_a=2000, n_item_b=3000, len_max=cfg.len_max)
        seqs = synthetic.generate_sequences(spec, args.synthetic,
                                            seed=cfg.seed)
        k = args.synthetic // 8
        train = preprocess.preprocess_train(seqs[:-2 * k], spec, cfg.seed)
        val = preprocess.preprocess_evaluate(
            seqs[-2 * k:-k], spec, cfg.n_neg_sample, cfg.seed,
            cfg.bug_truncated_b_neg_pool)
        test = preprocess.preprocess_evaluate(
            seqs[-k:], spec, cfg.n_neg_sample, cfg.seed,
            cfg.bug_truncated_b_neg_pool)
        gs, gp = build.build_graphs(seqs[:-2 * k], spec)
    else:
        root = os.getcwd()
        path_raw = args.path_raw or join(root, "data", "raw", dataset)
        path_data = args.path_data or join(root, "data", dataset)
        if not os.path.exists(path_raw):
            raise FileNotFoundError(f"raw dataset not found: {path_raw}")
        spec = raw.load_data_spec(path_raw, cfg.len_max)
        train = preprocess.load_or_build_split(
            path_raw, path_data, "train", spec, cfg.n_neg_sample, cfg.seed,
            use_raw=cfg.use_raw)
        val = preprocess.load_or_build_split(
            path_raw, path_data, "val", spec, cfg.n_neg_sample, cfg.seed,
            cfg.bug_truncated_b_neg_pool, use_raw=cfg.use_raw)
        test = preprocess.load_or_build_split(
            path_raw, path_data, "test", spec, cfg.n_neg_sample, cfg.seed,
            cfg.bug_truncated_b_neg_pool, use_raw=cfg.use_raw)
        gs, gp = build.build_graphs_from_file(
            raw.split_path(path_raw, "train"), spec)

    graphs = c2dsr.Graphs(share=spmm.device_graph(gs, device),
                          specific=spmm.device_graph(gp, device))
    desc = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    noter = Noter(cfg, device_desc=desc)
    noter.save_config()
    exp = Experiment(cfg, spec, graphs, train, val, test, noter=noter,
                     ckpt_path=args.ckpt, device=device)
    exp.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

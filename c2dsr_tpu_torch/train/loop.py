"""The experiment: epoch loop, model selection, early stop.

The counterpart of ``c2dsr_tpu/train/loop.py:36-224``, reproducing
main.py:100-148 of the reference: per epoch, train over all batches (graph
propagation inside each step), validate with ranking, compute the
improvement scalar, keep the test metrics from the best-validation epoch,
early-stop after ``es_patience`` epochs without improvement.  It adds what
the reference lacks: throughput counters, checkpoint save-on-best and
resume (``cfg.resume`` restores params, optimizer state and step and the
best-validation bookkeeping), a ``torch.profiler`` trace of the first epoch
(``cfg.profile_dir``) and a fail-fast debug mode (``cfg.debug_nans``).

Loss totals stay on the device across the epoch, with one host sync at the
epoch's end, so the host queues steps ahead of the card: a per-step
``float()`` would wait for every step.

With ``mesh_data * mesh_model > 1`` it runs as one rank of a mesh
(``parallel/mesh.py``; the process group is set up first,
``parallel/distributed.initialize``): every rank builds the same full
state from the seed and keeps its shards, attaches its part of the
sharded propagation's all-to-all schedule to both graphs when
``mesh_model > 1``, trains on its data index's rows of each global batch
(``BatchIterator`` sliced by the data index, not the process index) and
ranks its rows of each eval chunk, every example keeping its rank.
Checkpoints hold the whole state, written by rank 0
(``checkpoint.py``).  Runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from c2dsr_tpu_torch import checkpoint as ckpt_mod
from c2dsr_tpu_torch import metrics as metrics_mod
from c2dsr_tpu_torch.config import Config, DataSpec
from c2dsr_tpu_torch.data.pipeline import BatchIterator
from c2dsr_tpu_torch.evaluate import ranker
from c2dsr_tpu_torch.model import c2dsr
from c2dsr_tpu_torch.model import params as params_mod
from c2dsr_tpu_torch.noter import Noter
from c2dsr_tpu_torch.ops import backend
from c2dsr_tpu_torch.train import optim
from c2dsr_tpu_torch.train import step as step_mod


class Experiment:
    """Owns the data splits, graphs, model state and the step functions."""

    def __init__(self, cfg: Config, spec: DataSpec, graphs: c2dsr.Graphs,
                 train_data: Dict[str, np.ndarray],
                 val_data: Dict[str, np.ndarray],
                 test_data: Dict[str, np.ndarray],
                 noter: Optional[Noter] = None,
                 ckpt_path: Optional[str] = None, device="cuda"):
        self.device = backend.resolve_device(device)
        self.cfg, self.spec, self.graphs = cfg, spec, graphs
        self.noter = noter
        self.ckpt_path = ckpt_path
        self.mesh = None
        if cfg.world_size > 1:
            from c2dsr_tpu_torch.parallel import mesh as mesh_mod
            self.mesh = mesh_mod.make_mesh(cfg.mesh_data, cfg.mesh_model)
        data_index = self.mesh.data_index if self.mesh else 0
        self.train_iter = BatchIterator(train_data, cfg.batch_size,
                                        shuffle=True, seed=cfg.seed,
                                        process_index=data_index,
                                        process_count=cfg.mesh_data)
        self.val_data, self.test_data = val_data, test_data
        self.n_tr = self.train_iter.n
        if cfg.mesh_model > 1:
            from c2dsr_tpu_torch.config import padded_sizes
            from c2dsr_tpu_torch.ops import spmm as spmm_mod
            n_p = padded_sizes(cfg, spec)[0]
            self.graphs = graphs = c2dsr.Graphs(*(
                spmm_mod.attach_a2a_plan(g, n_p, cfg.mesh_model,
                                         self.mesh.model_index)
                for g in graphs))

        steps_per_epoch = max(len(self.train_iter), 1)
        self.optimizer = optim.make_optimizer(cfg, steps_per_epoch)
        params = params_mod.init_params(
            cfg, spec, torch.Generator().manual_seed(cfg.seed), self.device)
        if self.mesh is not None and cfg.mesh_model > 1:
            from c2dsr_tpu_torch.parallel import mesh as mesh_mod
            params = mesh_mod.shard_params(params, self.mesh)
        self.state = step_mod.init_state(params, self.optimizer, self.mesh)
        # each step's dropout seed follows (cfg.seed + 1, state.step)
        self.train_step = step_mod.make_train_step(
            cfg, spec, graphs, self.optimizer, self.device, mesh=self.mesh)
        self.convolve_eval, self.rank_step = ranker.make_eval_fns(
            cfg, spec, graphs, self.device, mesh=self.mesh)
        self._profiled = False
        if cfg.debug_nans:
            torch.autograd.set_detect_anomaly(True)

        # resume: restore TrainState + best-validation bookkeeping
        self._start_epoch = 0
        self._best = {"imp_val_best": -1.0, "res_test": [0.0] * 13,
                      "es_counter": 0}
        if ckpt_path and cfg.resume and ckpt_mod.exists(ckpt_path):
            self.state = ckpt_mod.restore(ckpt_path, template=self.state,
                                          mesh=self.mesh)
            meta = ckpt_mod.load_meta(ckpt_path)
            self._start_epoch = int(meta.get("epoch", 0))
            for k in self._best:
                if k in meta:
                    self._best[k] = meta[k]
            if self.noter:
                self.noter.log_msg(
                    f"[Info] resumed from {ckpt_path} at epoch "
                    f"{self._start_epoch} (best improvement "
                    f"{self._best['imp_val_best']:.4f})")

    # ----- phases ----------------------------------------------------------
    def _profiler(self):
        """A torch.profiler context for the first epoch under
        ``cfg.profile_dir``, else None."""
        if not self.cfg.profile_dir or self._profiled:
            return None
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def run_train_epoch(self):
        t0 = time.time()
        # device-resident epoch totals: [loss, rec, mi] example-weighted
        # sums and the real example count (one host sync at the epoch's end)
        tot = torch.zeros(4, device=self.device)
        if self.cfg.bug_epoch_grad_accum:
            # reference parity: optimizer.zero_grad() once per epoch
            # (trainer.py:42) clears the running gradient sum
            self.optimizer.reset_grad_accum(self.state.opt_state)
        prof = self._profiler()
        with prof if prof is not None else contextlib.nullcontext():
            for batch in self.train_iter.epoch():
                self.state, aux = self.train_step(self.state, batch)
                bs = aux["n_examples"]
                tot = tot + torch.stack([aux["loss"] * bs,
                                         aux["loss_rec"] * bs,
                                         aux["loss_mi"] * bs, bs])
            tot = tot.cpu().numpy()         # the single host sync
        if prof is not None:
            os.makedirs(self.cfg.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.cfg.profile_dir,
                                                  "train_epoch.json"))
            self._profiled = True
        dt = time.time() - t0
        if self.cfg.debug_nans and not np.isfinite(tot).all():
            raise FloatingPointError(
                f"non-finite training loss: {tot.tolist()}")
        n = float(tot[3])
        loss_tr, loss_rec, loss_mi = (tot[:3] / max(n, 1.0)).tolist()
        if self.noter:
            self.noter.log_train(loss_tr, loss_rec, loss_mi, dt,
                                 examples_per_s=n / max(dt, 1e-9))
        return loss_tr, loss_rec, loss_mi

    def run_eval(self, data) -> tuple:
        hi = self.convolve_eval(self.state.params)
        to_global = None
        if self.mesh is not None and self.mesh.n_data > 1:
            from c2dsr_tpu_torch.parallel import mesh as mesh_mod

            def to_global(chunk):
                return mesh_mod.eval_slice(chunk, self.mesh)

        return ranker.evaluate_split(self.state.params, hi, data,
                                     self.rank_step, self.cfg,
                                     to_global=to_global)

    # ----- full experiment -------------------------------------------------
    def run(self) -> Dict[str, object]:
        cfg = self.cfg
        imp_val_best = float(self._best["imp_val_best"])
        res_test_imp = list(self._best["res_test"])
        es_counter = int(self._best["es_counter"])
        epoch = self._start_epoch
        for epoch in range(self._start_epoch + 1, cfg.n_epoch + 1):
            if self.noter:
                self.noter.log_msg(f"\n[Epoch {epoch}]")
            self.run_train_epoch()
            ranks_a, ranks_b = self.run_eval(self.val_data)
            res_val = metrics_mod.cal_score(ranks_a, ranks_b, cfg.benchmark)
            if self.noter:
                self.noter.log_evaluate("valid", res_val)

            if res_val[0] > imp_val_best:
                imp_val_best = res_val[0]
                ranks_a, ranks_b = self.run_eval(self.test_data)
                res_test_imp = metrics_mod.cal_score(ranks_a, ranks_b,
                                                     cfg.benchmark)
                if self.noter:
                    self.noter.log_evaluate("test", res_test_imp)
                es_counter = 0
                if self.ckpt_path:
                    ckpt_mod.save(self.ckpt_path, self.state,
                                  meta={"epoch": epoch,
                                        "imp_val_best": imp_val_best,
                                        "res_test": list(res_test_imp),
                                        "es_counter": es_counter},
                                  mesh=self.mesh)
            else:
                es_counter += 1
                if self.noter:
                    self.noter.log_msg(
                        f"\t| es    | {es_counter} / {cfg.es_patience} |")
                if es_counter >= cfg.es_patience:
                    break

        if self.ckpt_path:
            ckpt_mod.wait()      # join the last async save-on-best commit
        if self.noter:
            self.noter.log_final_result(epoch, imp_val_best, res_test_imp)
        return {"epoch": epoch, "imp_val_best": imp_val_best,
                "res_test": res_test_imp}

"""Console + file logging with the reference's exact output formats.

The port's own copy of ``c2dsr_tpu/noter.py`` (utils/noter.py:7-98 of the
reference): the same fixed-width train, eval and final tables and the same
log-file naming, plus the examples/s counter.  The device text is what the
caller passes: the card's name on the GPU (``torch.cuda.get_device_name``).
"""

from __future__ import annotations

import os
import time
from os.path import join
from typing import List, Optional

from c2dsr_tpu_torch.config import Config


class Noter:
    def __init__(self, cfg: Config, log_dir: str = "log",
                 device_desc: str = "cpu"):
        self.cfg = cfg
        self.benchmark = cfg.benchmark
        os.makedirs(log_dir, exist_ok=True)
        self.f_log = join(
            log_dir,
            cfg.data + time.strftime("-%m-%d-%H:%M-", time.localtime())
            + f"{cfg.n_gnn}-{cfg.n_attn}-{cfg.n_head}-{cfg.lr}-{cfg.l2}.txt")
        if os.path.exists(self.f_log):
            os.remove(self.f_log)
        self.device_desc = device_desc
        self.log_welcome()

    def write(self, msg: str) -> None:
        with open(self.f_log, "a") as out:
            print(msg, file=out)

    def log_msg(self, msg: str) -> None:
        print(msg)
        self.write(msg)

    def log_settings(self) -> None:
        c = self.cfg
        self.log_msg(
            f"\n[Info] Experiment (dataset:{c.dataset}, device:{self.device_desc}) "
            f"\n\t| lr {c.lr:.2e} | l2 {c.l2:.2e} |"
            f"\n\t| n_gnn  {c.n_gnn} | dropout {c.dropout_gnn} |"
            f"\n\t| n_attn {c.n_attn} | dropout {c.dropout_attn} | n_head {c.n_head} |\n")

    def log_welcome(self) -> None:
        self.log_msg("\n" + "-" * 20 + " Experiment: C2DSR (TPU-native) " + "-" * 20)
        self.log_settings()

    def save_config(self) -> None:
        info = "-" * 10 + " Experiment settings " + "-" * 10 + "\n"
        for k, v in vars(self.cfg).items():
            info += f"\n\t{k} : {v}"
        self.write(info + "\n")

    def log_train(self, loss_tr: float, loss_rec: float, loss_mi: float,
                  t_gap: float, examples_per_s: Optional[float] = None) -> None:
        msg = (f"\t| train |\n\t| loss {loss_tr:.4f} | rec {loss_rec:.4f} "
               f"| mi {loss_mi:.4f} | time {t_gap:.0f}s |")
        if examples_per_s is not None:
            msg += f" {examples_per_s:.0f} ex/s |"
        self.log_msg(msg + "\n")

    def log_evaluate(self, mode: str, res: List[float]) -> None:
        msg = (f"\t| {mode:5} |\n\t| Improve | hr5_a  | hr20_a "
               f"| mrr5_a | mrr20_a | ndcg5_a | ndcg20_a | hr5_b  | hr20_b | mrr5_b | mrr20_b "
               f"| ndcg5_b | ndcg20_b |\n"
               f"\t| {res[0]:+.4f} | {res[1]:.4f} | {res[2]:.4f} | {res[3]:.4f} | {res[4]:.4f}  | {res[5]:.4f}  "
               f"| {res[6]:.4f}   | {res[7]:.4f} | {res[8]:.4f} | {res[9]:.4f} | {res[10]:.4f}  | {res[11]:.4f}  "
               f"| {res[12]:.4f}   |")
        msg += "\n" if mode == "valid" else ""
        self.log_msg(msg)

    def log_final_result(self, epoch: int, imp_val_best: float,
                         res: List[float]) -> None:
        self.log_msg("\n" + "-" * 10
                     + f" C2DSR (TPU-native) experiment ends at epoch {epoch} "
                     + "-" * 10)
        self.log_settings()
        msg = (f"[ Valid result ]\n\t| Improve |\n\t| {imp_val_best:+.4f} |\n\n"
               f"[ Test result ]\n\t| Improve | hr5_a  | hr20_a | mrr5_a | mrr20_a | ndcg5_a | ndcg20_a | hr5_b  "
               f"| hr20_b | mrr5_b | mrr20_b | ndcg5_b | ndcg20_b |\n"
               f"\t| {res[0]:+.4f} | {res[1]:.4f} | {res[2]:.4f} | {res[3]:.4f} | {res[4]:.4f}  | {res[5]:.4f}  "
               f"| {res[6]:.4f}   | {res[7]:.4f} | {res[8]:.4f} | {res[9]:.4f} | {res[10]:.4f}  | {res[11]:.4f}  "
               f"| {res[12]:.4f}   |\n")
        self.log_msg(msg)

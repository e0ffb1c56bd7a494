"""Training launcher: the port of ``repro/launch/train.py``.

Trains a config end to end with the full LCAP tracking stack on one
device: the card unless ``--device cpu`` is given.  fp32 master weights,
AdamW, ``naive`` attention (the reference's default; the attention
kernel has no backward pass).  Prints the reference launcher's JSON.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 5 \\
        --workdir /path/to/run
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--n-hosts", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    from .. import configs as C
    from ..runtime.train_loop import Trainer

    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    trainer = Trainer(cfg, workdir=args.workdir,
                      global_batch=args.global_batch, seq_len=args.seq_len,
                      n_hosts=args.n_hosts, ckpt_every=args.ckpt_every,
                      device=args.device)
    hist = trainer.run(args.steps)
    trainer.ckpt.wait()
    rows = trainer.metrics[0].query(
        "SELECT COUNT(*), COUNT(DISTINCT type) FROM events")
    print(json.dumps({
        "arch": cfg.arch_id,
        "steps": [h["step"] for h in hist[-3:]],
        "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
        "metrics_rows": rows[0][0], "event_types": rows[0][1],
        "stragglers": sorted(trainer.straggler.flagged),
        "last_ckpt": trainer.committer.latest_committed(),
    }, indent=1))
    trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

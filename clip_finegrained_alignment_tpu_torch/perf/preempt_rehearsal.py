"""Preemption rehearsal on the card, the port of
``perf/preempt_rehearsal.sh``: a SPARC fine-tune in a child process gets a
real SIGTERM mid-epoch (a cluster's preemption signal) and must

1. commit an atomic ``<ckpt>/preempt/`` checkpoint (``meta.json`` with
   ``preempted: true``, its ``global_step`` and ``epoch``) and exit 0;
2. resume with ``--resume <ckpt>/preempt/`` step-exact (the interrupted
   epoch's completed steps skipped) to the end of the run;

and, beyond the JAX script, 3. the resumed run's final weights must equal
an unbroken run's bit for bit.

    python -m clip_finegrained_alignment_tpu_torch.perf.preempt_rehearsal \\
        [--out DIR] [--model ViT-B/32] [--samples 2048] [--batch 32] \\
        [--epochs 20] [--wait-steps 5]

Stage 1 is ``cli/generate_data.py --procedural --annotation-mode count
--seed 11`` (``--data DIR`` takes an existing procedural dataset). Stage
2 starts ``python -m clip_finegrained_alignment_tpu_torch.cli.train
--loss-type sparc --inverse-temperature 0.07 --batch-size BATCH
--grad-accum 1 --save-every 1 --log-every 1`` as a child process, its
output in ``OUT/train.log``, polls the log for step ``WAIT_STEPS`` and
sends SIGTERM (from a thread), while this process runs the unbroken run
with the same flags (``cli/train.py``'s ``main``, in the main thread,
where the CLI installs its SIGTERM handler). Stage 3 runs the resume in
this process.

Prints the stages' lines, then ONE JSON line (returned by :func:`main`):
the step the signal followed and the one ``preempt/`` holds, the child's
exit code and seconds, the resumed run's skipped steps and last step,
whether the weights are equal, the runs' epoch losses, ``device`` and
``gpu`` (the card's name and power limit). A failed check raises
``SystemExit`` after the line. The device is the card; ``--device cpu``
is for the tests (``--model tiny``, ``--image-size 64``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

from . import _drill
from ._measure import device_fields
from ..models.clip import resolve_device

EXPERIMENT = "preempt"
POLL_S = 0.05


def wait_for_step(proc, log_path: str, step: int, timeout: float) -> str:
    """Poll ``log_path`` until the child logs optimizer step ``step``;
    returns the log's last step line. Raises if the child exits first or
    ``timeout`` passes."""
    needle = f" step {step} "
    t_end = time.time() + timeout
    while time.time() < t_end:
        if proc.poll() is not None:
            raise SystemExit(f"train exited (rc {proc.returncode}) before "
                             f"the signal — log tail:\n{tail(log_path)}")
        with open(log_path, errors="replace") as f:
            lines = [ln for ln in f.read().splitlines() if " step " in ln
                     and " loss " in ln]
        if any(needle in f"{ln} " for ln in lines):
            return lines[-1]
        time.sleep(POLL_S)
    raise SystemExit(f"never reached step {step} in {timeout:.0f} s — log "
                     f"tail:\n{tail(log_path)}")


def tail(path: str, n: int = 5) -> str:
    with open(path, errors="replace") as f:
        return "\n".join(f.read().splitlines()[-n:])


def same_weights(a, b) -> bool:
    """Whether two models on one device hold the same tensors bit for
    bit."""
    import torch
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


def run(out: str, model: str = "ViT-B/32", samples: int = 2048,
        batch: int = 32, epochs: int = 20, wait_steps: int = 5,
        image_size: int = 224, amp: bool = True, data: Optional[str] = None,
        device="cuda", timeout: float = 1800.0) -> dict:
    """The four stages; returns the JSON line's fields."""
    device = resolve_device(device)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t_start = time.time()
    line = {"drill": "preempt_rehearsal", "model": model,
            "samples": samples, "batch": batch, "epochs": epochs,
            "wait_steps": wait_steps}
    if data is None:
        print(f"== stage 1: procedural dataset ({samples} samples) ==",
              flush=True)
        anns = _drill.generate(os.path.join(out, "data"), samples, 11,
                               image_size, ["--annotation-mode", "count"])
    else:
        anns = os.path.join(data, "synthetic_annotations.json")
        print(f"== stage 1: the procedural dataset in {data} ==",
              flush=True)

    def flags(ckpt):
        return ["--annotations", anns, "--model", model, "--loss-type",
                "sparc", "--inverse-temperature", "0.07", "--batch-size",
                str(batch), "--grad-accum", "1", "--epochs", str(epochs),
                "--experiment-name", EXPERIMENT, "--checkpoint-dir", ckpt,
                "--save-every", "1", "--log-every", "1"] + (
                    [] if amp else ["--no-amp"])

    print(f"== stage 2: train {model} in a child process, SIGTERM after "
          f"step {wait_steps}; beside it, the unbroken run ==", flush=True)
    ckpt = os.path.join(out, "ckpts")
    log_path = os.path.join(out, "train.log")
    env = dict(os.environ, CFA_ALLOW_HASH_TOKENIZER="1", PYTHONUNBUFFERED="1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    child = {}

    def preempt_child(proc, t0):
        """Poll the child's log for the step, signal it, wait for its
        exit; what it saw goes to ``child``."""
        try:
            at = wait_for_step(proc, log_path, wait_steps, timeout)
            print(f"-- delivering SIGTERM at {at.split(' loss ')[0]} --",
                  flush=True)
            proc.send_signal(signal.SIGTERM)
            child.update(signal_after=at.split(" loss ")[0],
                         child_rc=proc.wait(timeout=timeout),
                         child_s=time.time() - t0)
        except BaseException as e:        # re-raised by the main thread
            child["error"] = e

    with open(log_path, "w") as log:
        t0 = time.time()
        proc = subprocess.Popen(
            [sys.executable, "-m", "clip_finegrained_alignment_tpu_torch.cli"
             ".train", *flags(ckpt), "--metrics-file",
             os.path.join(out, "metrics.jsonl"), "--device", str(device)],
            stdout=log, stderr=subprocess.STDOUT, env=env)
        watcher = threading.Thread(target=preempt_child, args=(proc, t0))
        watcher.start()
        try:
            # The unbroken run in this process (the main thread: the CLI
            # installs its SIGTERM handler) while the child runs.
            whole, unbroken = _drill.train(
                flags(os.path.join(out, "unbroken")), device)
        except BaseException:
            proc.kill()          # the watcher sees it exit and returns
            raise
        finally:
            watcher.join(timeout + 60)
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if "error" in child:
        raise child["error"]
    line.update(child, unbroken_steps=unbroken["steps"],
                unbroken_epoch_losses=unbroken["epoch_losses"],
                unbroken_epoch_pairs_per_s=unbroken["epoch_pairs_per_s"])
    rc = child["child_rc"]
    print(f"train exit code: {rc}", flush=True)
    with open(log_path, errors="replace") as f:
        said = [ln for ln in f.read().splitlines() if "preempted" in ln]
    print("\n".join(said))
    pre = os.path.join(ckpt, EXPERIMENT, "preempt")
    meta = None
    if os.path.exists(os.path.join(pre, "meta.json")):
        with open(os.path.join(pre, "meta.json")) as f:
            meta = json.load(f)
        print(f"preempt checkpoint committed: global_step="
              f"{meta['global_step']} epoch={meta['epoch']}", flush=True)
    line.update(preempt_logged=bool(said), preempt_meta=None if meta is None
                else {k: meta[k] for k in ("preempted", "global_step",
                                           "epoch")})

    print("== stage 3: step-exact resume ==", flush=True)
    spe = samples // batch
    res, resumed = _drill.train(
        flags(ckpt) + ["--resume", pre], device) if meta else (None, None)
    if res is not None:
        print(f"resumed from {pre} at step {res['resumed_at_step']}, "
              f"skipping {res['skipped_steps']} completed steps; done at "
              f"step {resumed['steps']}", flush=True)
        line.update(resumed_at_step=res["resumed_at_step"],
                    skipped_steps=res["skipped_steps"],
                    resumed_steps=resumed["steps"],
                    resumed_epoch_losses=resumed["epoch_losses"],
                    steps_expected=spe * epochs)
    line["weights_equal"] = res is not None and same_weights(
        res["trainer"].model, whole["trainer"].model)
    print(f"resumed weights equal the unbroken run's bit for bit: "
          f"{line['weights_equal']}", flush=True)
    del res, whole
    _drill.release(device)
    line["seconds"] = time.time() - t_start
    line.update(device_fields(device))
    line["ok"] = bool(
        rc == 0 and said and meta and meta["preempted"] is True
        and line["skipped_steps"] > 0
        and line["resumed_at_step"] == meta["global_step"]
        and line["resumed_steps"] == spe * epochs
        and line["unbroken_steps"] == spe * epochs and line["weights_equal"])
    return line


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=_drill.default_out("preempt_rehearsal"))
    ap.add_argument("--model", default="ViT-B/32")
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--wait-steps", type=int, default=5,
                    help="deliver SIGTERM once the child logs this step")
    ap.add_argument("--image-size", type=int, default=224,
                    help="procedural frame size")
    ap.add_argument("--no-amp", action="store_true",
                    help="train in fp32 (cli/train.py --no-amp)")
    ap.add_argument("--data", default=None, metavar="DIR",
                    help="an existing procedural dataset: skips stage 1")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds to wait for the child's step and exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line = run(args.out, args.model, args.samples, args.batch, args.epochs,
               args.wait_steps, args.image_size, not args.no_amp, args.data,
               args.device, args.timeout)
    print(json.dumps(line), flush=True)
    if not line["ok"]:
        raise SystemExit("PREEMPT REHEARSAL FAILED: see the line above")
    print("PREEMPT REHEARSAL OK", flush=True)
    return line


if __name__ == "__main__":
    main()

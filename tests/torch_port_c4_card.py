"""Fault C4's runs on one GPU at the JAX package's own small configurations
(ROADMAP.md §C): not a test file and not part of the port; it imports
nothing of JAX. Run from the repository's root,

    python tests/torch_port_c4_card.py md2 OUTDIR [--jobs N] [--seeds 0 1 2]
        [--variants V ...]

runs tools/synthetic_benchmark at 64x192 for 40 epochs (420 frames, batch
12, switch epoch 6, bucketing on, scene seed 0 under
logs/synth_scene_64x192, rendered there first if missing) through
tests/torch_port_c4_record.py run --trainer-seed K for each variant of
VARIANTS and each trainer seed, N runs at a time on the one card, writing
OUTDIR/synth_md2_64x192_<variant>_s<K>_torch.json; the bf16 runs keep
their last checkpoint, and each is then scored with
tools/synthetic_pose_eval on its default sequence (80 frames at 192x64),
beside the untrained network, into OUTDIR/synth_pose_64x192_torch.json.

    python tests/torch_port_c4_card.py sql OUTDIR --init FILE.pt --draw J

trains SQLdepth at 128x512 (the smallest size at KITTI's aspect that its
head takes: 64 patch tokens; 64x192 gives 12) for the tool's 12 epochs
(bf16, head dropout on) from the init in FILE.pt (tests/torch_port_c4.py
jax-init --height 128 --width 512 OUT.pt J writes JAX's PRNGKey(J) draw)
at trainer seed 0, on the scene of seed 0 under logs/synth_scene_128x512
(rendered there first if missing), writing
OUTDIR/c4_sql_128x512_jax<J>_torch.json.

    python tests/torch_port_c4_card.py summary OUTDIR

reads OUTDIR's md2 records and holds each run to the bands written
before the runs (BANDS), under 0.6 x init, and each bf16 run's pose ATE
to at most 0.12 and below the untrained network's; then the sql runs,
each flat or not (final abs_rel 0.45 or more), and the gate (2-6 of 8
flat) for comparing them with the JAX package's own Trainer.

Each line printed says what ran and what it gave, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "tests", "torch_port_c4_record.py")
SMALL = ["--width", "192", "--height", "64", "--epochs", "40", "--root", "logs/synth_scene_64x192"]
# the JAX package's 64x192 table (its TPU runs, 40 epochs), one variant a row,
# and the seed-1 scene with the bias
VARIANTS = {
    "bf16": [],
    "bf16_bias": ["--disp-bias", "-2.2"],
    "f32": ["--dtype", "float32"],
    "f32_bias": ["--dtype", "float32", "--disp-bias", "-2.2"],
    "bf16_bias_ps0.5": ["--disp-bias", "-2.2", "--pose-scale", "0.5"],
    "scene1_bf16_bias": ["--seed", "1", "--disp-bias", "-2.2"],
}


def run(cmd: list, log: str) -> int:
    with open(log, "w") as f:
        return subprocess.call([sys.executable, *cmd], stdout=f, stderr=subprocess.STDOUT,
                               cwd=REPO)


def last_line(log: str) -> str:
    with open(log) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def ensure_scenes(variants) -> None:
    from baseboostdepth_tpu_torch.tools.synthetic_benchmark import ensure_scene

    for seed in sorted({1 if "--seed" in VARIANTS[v] else 0 for v in variants}):
        root = "logs/synth_scene_64x192" + ("" if seed == 0 else f"_seed{seed}")
        ensure_scene(os.path.join(REPO, root), 420, 192, 64, seed)


def md2(opts) -> None:
    ensure_scenes(opts.variants)
    jobs = []
    for v in opts.variants:
        for k in opts.seeds:
            out = os.path.join(opts.outdir, f"synth_md2_64x192_{v}_s{k}_torch.json")
            keep = ["--keep-checkpoint"] if "float32" not in VARIANTS[v] else []
            jobs.append((v, k, out, ["run", out, "--trainer-seed", str(k), *keep, "--",
                                     *SMALL, *VARIANTS[v]]))

    def train(job):
        v, k, out, args = job
        t = time.time()
        rc = run([RECORD, *args], out[:-5] + ".log")
        print(f"{v} s{k}: rc={rc} {time.time() - t:.0f} s | {last_line(out[:-5] + '.log')}",
              flush=True)
        return rc

    with ThreadPoolExecutor(opts.jobs) as pool:
        rcs = list(pool.map(train, jobs))

    # the bf16 checkpoints' pose ATE, and the untrained network's
    scored = [(None, None, None)]
    for (v, k, out, _), rc in zip(jobs, rcs):
        if rc == 0 and "float32" not in VARIANTS[v]:
            with open(out) as f:
                scored.append((v, k, os.path.join(json.load(f)["log_path"], "checkpoints")))

    def score(item):
        v, k, ckpt = item
        out = os.path.join(opts.outdir, f"pose_{v or 'untrained'}_s{k}.json")
        rc = run([RECORD, "pose", out] + ([] if ckpt is None else ["--ckpt", ckpt]),
                 out[:-5] + ".log")
        if rc:
            return {"variant": v, "trainer_seed": k, "rc": rc}
        with open(out) as f:
            return {"variant": v or "untrained", "trainer_seed": k, **json.load(f)}

    with ThreadPoolExecutor(opts.jobs) as pool:
        ates = list(pool.map(score, scored))
    with open(os.path.join(opts.outdir, "synth_pose_64x192_torch.json"), "w") as f:
        json.dump(ates, f, indent=1)
    for a in ates:
        print(f"pose {a['variant']} s{a['trainer_seed']}: ate_direct "
              f"{a.get('ate_direct')} ate_chained {a.get('ate_chained')} | {a.get('device')}")
    if any(rcs):
        raise SystemExit(f"{sum(1 for rc in rcs if rc)} runs failed")


def sql(opts) -> None:
    from baseboostdepth_tpu_torch.tools.synthetic_benchmark import ensure_scene

    root = "logs/synth_scene_128x512"
    ensure_scene(os.path.join(REPO, root), 420, 512, 128, 0)
    out = os.path.join(opts.outdir, f"c4_sql_128x512_jax{opts.draw}_torch.json")
    t = time.time()
    rc = run([RECORD, "run", out, "--init-state", opts.init, "--trainer-seed", "0", "--",
              "--zoo", "sql", "--width", "512", "--height", "128", "--root", root],
             out[:-5] + ".log")
    print(f"sql 128x512 JAX PRNGKey({opts.draw}): rc={rc} {time.time() - t:.0f} s | "
          f"{last_line(out[:-5] + '.log')}", flush=True)
    if rc:
        raise SystemExit(rc)


# the bands written before the runs (the JAX package's TPU result + 0.03
# abs_rel / - 0.04 a1): final abs_rel at most / a1 at least;
# None: no band, the count of seeds that escape (final abs_rel under ESCAPED)
BANDS = {"bf16_bias": (0.203, 0.805), "f32_bias": (0.220, 0.763),
         "bf16_bias_ps0.5": (0.208, 0.794), "bf16": (0.210, 0.783), "f32": None,
         "scene1_bf16_bias": None}
ESCAPED = 0.45
POSE_BAND = 0.12  # ate_direct at most, and below the untrained network's


def summary(opts) -> None:
    """Each run of OUTDIR against its band (a configuration with a bias is
    in its band when its seed-0 run is; without one, the runs that escape
    are held to it), under 0.6 x init, and each bf16 run's pose ATE."""
    pose = {}
    path = os.path.join(opts.outdir, "synth_pose_64x192_torch.json")
    if os.path.exists(path):
        with open(path) as f:
            pose = {(a["variant"], a["trainer_seed"]): a for a in json.load(f)}
    untrained = pose.get(("untrained", None), {}).get("ate_direct")
    for v in VARIANTS:
        for k in opts.seeds:
            path = os.path.join(opts.outdir, f"synth_md2_64x192_{v}_s{k}_torch.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                rec = json.load(f)
            r, band = rec["result"], BANDS[v]
            init, final = r["init"], r["final"]
            escaped = final["abs_rel"] < ESCAPED
            line = (f"{v} s{k}: abs_rel {init['abs_rel']:.4f} -> {final['abs_rel']:.4f} "
                    f"({final['abs_rel'] / init['abs_rel']:.3f} x init), a1 {init['a1']:.4f} -> "
                    f"{final['a1']:.4f}, {'escaped' if escaped else 'flat'}")
            if band is not None and (escaped or "bias" in v):
                inside = final["abs_rel"] <= band[0] and final["a1"] >= band[1]
                line += f"; band {band[0]} / {band[1]}: {'in' if inside else 'OUT'}"
            line += f"; under 0.6 x init: {final['abs_rel'] < 0.6 * init['abs_rel']}"
            a = pose.get((v, k))
            if a is not None:
                ok = a["ate_direct"] <= POSE_BAND and untrained is not None \
                    and a["ate_direct"] < untrained
                line += (f"; ate_direct {a['ate_direct']:.4f} (chained {a['ate_chained']:.4f},"
                         f" untrained {untrained:.4f}): {'in' if ok else 'OUT'}")
            print(f"{line}; wall {r['wall_s']} s | {rec['device']}")
    flat = []
    for j in range(8):
        path = os.path.join(opts.outdir, f"c4_sql_128x512_jax{j}_torch.json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            r = rec["result"]
            flat.append(r["final"]["abs_rel"] >= ESCAPED)
            print(f"sql 128x512 JAX PRNGKey({j}): abs_rel {r['init']['abs_rel']:.4f} -> "
                  f"{r['final']['abs_rel']:.4f}, a1 {r['final']['a1']:.4f}, "
                  f"{'flat' if flat[-1] else 'left the plateau'} | {rec['device']}")
    if flat:
        print(f"sql gate: {sum(flat)} of {len(flat)} runs flat (the comparison with JAX's "
              f"Trainer goes on at 2-6 of 8): {'passed' if 2 <= sum(flat) <= 6 else 'failed'}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["md2", "sql", "summary"])
    ap.add_argument("outdir")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--init", default=None)
    ap.add_argument("--draw", type=int, default=0)
    opts = ap.parse_args(argv)
    os.makedirs(opts.outdir, exist_ok=True)
    sys.path.insert(0, REPO)
    {"md2": md2, "sql": sql, "summary": summary}[opts.what](opts)


if __name__ == "__main__":
    main()

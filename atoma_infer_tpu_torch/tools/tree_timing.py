"""Time two checkouts of the port on one card in one call: the kernels'
build, and the attention kernels at the widths' own head dims.

A change to the attention sources must not slow the head dims the widths
are built for, nor the build, by more than a margin; two calls may land on
two cards or hosts, so both versions are timed in one call, in turns
(``--trees parent change change parent``). Each tree runs in a process of
its own that imports that tree's ``atoma_infer_tpu_torch`` and its
``chip_smoke.py`` (this file imports nothing of the package, so it times a
checkout older than itself):

* the build: every run deletes the tree's ``csrc/build/`` and times
  ``cuda_lib.build_all()`` anew, so that each tree's build is timed in
  every turn (one build a tree spreads by about 10%);
* kernel A (bf16 queries over a bf16 cache) on the mixed batch and kernel B
  on the 64 decode rows of ``chip_smoke.py``'s kernels line at
  Llama-3.2-1B's attention (32 q heads over 8 kv heads of 64), D (INT8
  cache) and E (e4m3 cache), ragged and fused, on its batches at
  Llama-3.1-8B's (32 over 8 of 128), and A and B on the width 512's rows
  (``check_wide_head_kernels``: Gemma-2-9B's widths with heads of 512, 8 q
  heads over 4 kv heads, soft cap 50, keys up to 1,023 on the mixed
  batch): the sequences from this checkout's ``chip_smoke.kernel_line_specs``
  and the rest of the batch from the same generator state as the kernels
  line, built by the tree's own ``make_batch`` and ``kv8_cache`` and timed
  by its ``cuda_ms`` (50 launches after 5).

Before the timed turns every tree runs one turn of its own, untimed (its
numbers printed and left out of the means): a tree's first timed kernels
read up to 22% slow on code that did not change, and the warm-up takes
that turn.

Usage (on the card, from the root of a checkout; the parent unpacked with
``git archive`` into a directory of the checkout that ``.gitignore``
lists)::

    mkdir -p _chip_scratch/parent
    git archive HEAD~1 | tar -x -C _chip_scratch/parent
    python3 atoma_infer_tpu_torch/tools/tree_timing.py \\
        --trees _chip_scratch/parent . . _chip_scratch/parent

A tree must lie inside the working directory, since its build directory is
deleted. Prints one line per run (the build, its five slowest sources and
each kernel's time) and a JSON summary (each kernel's time and the build by
tree, the runs' means, and the change against the first tree in
percent).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

ITERS, WARMUP = 50, 5
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# (label, kernels-line seed, q heads, kv heads, head dim, cache kinds, the
# mixed batch's longest row, score modifiers): the 1B's A and B rows
# (chip_smoke.py check_kernels), the 8B's D and E rows (check_kv8_kernels)
# and the width 512's A and B rows (check_wide_head_kernels).
SHAPES = (("1B", 0, 32, 8, 64, (None,), 2048, {}),
          ("8B", 1, 32, 8, 128, ("int8", "fp8"), 2048, {}),
          ("Gemma-2-9B D=512", 512, 8, 4, 512, (None,), 1024, dict(soft_cap=50.0)))


def batch_specs() -> dict:
    """Each shape's kernels-line sequences and the generator state after
    drawing them, from this checkout's ``chip_smoke.py``."""
    import numpy as np

    sys.path.insert(0, CHECKOUT)
    import chip_smoke

    specs = {}
    for label, seed, *_, max_keys, _ in SHAPES:
        rng = np.random.default_rng(seed)
        mixed, decode = chip_smoke.kernel_line_specs(rng, max_keys=max_keys)
        specs[label] = dict(mixed=mixed, decode=decode, rng=rng.bit_generator.state)
    return specs


def worker(tree: str, specs: dict) -> dict:
    """One run: build ``tree``'s kernels anew, then time them."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import chip_smoke
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    if not torch.cuda.is_available():
        raise SystemExit("tree_timing: no CUDA device")
    for module in (cuda_lib, chip_smoke):
        assert module.__file__.startswith(os.path.abspath(tree)), module.__file__
    shutil.rmtree(cuda_lib.BUILD_DIR, ignore_errors=True)
    t0 = time.monotonic()
    logs = cuda_lib.build_all()
    build_s = time.monotonic() - t0
    # The sources that finished last, which set the build's wall.
    slowest = sorted(((float(re.match(r"built in (\S+) s", text).group(1)), source)
                      for source, text in logs.items()), reverse=True)[:5]
    ms = {}
    dev = torch.device("cuda")
    for label, _, hq, hk, d, kinds, _, mods in SHAPES:
        rng = np.random.default_rng()
        rng.bit_generator.state = specs[label]["rng"]
        shape = dict(hq=hq, hk=hk, d=d, bs=16, dtype=torch.bfloat16, device=dev)
        mixed = chip_smoke.make_batch(rng, [tuple(s) for s in specs[label]["mixed"]],
                                      num_blocks=4096, decode_only=False, **shape)
        decode = chip_smoke.make_batch(rng, [tuple(s) for s in specs[label]["decode"]],
                                       num_blocks=8192, decode_only=True, **shape)
        for kind in kinds:
            name = {None: "A/B", "int8": "D", "fp8": "E"}[kind]
            cache, scales = ((mixed["cache"], None) if kind is None
                             else chip_smoke.kv8_cache(torch, mixed["cache"], kind, d))
            ms[f"{label} {name} ragged"] = chip_smoke.cuda_ms(
                lambda: pa.ragged_paged_attention_cuda(
                    mixed["q"], cache, mixed["meta"], scale=d ** -0.5, kv_scales=scales, **mods),
                iters=ITERS, warmup=WARMUP)
            dcache, dscales = ((decode["cache"], None) if kind is None
                               else chip_smoke.kv8_cache(torch, decode["cache"], kind, d))
            ms[f"{label} {name} fused"] = chip_smoke.cuda_ms(
                lambda: pa.ragged_paged_attention_fused_cuda(
                    decode["q"], dcache, decode["k"], decode["v"], decode["meta"],
                    scale=d ** -0.5, kv_scales=dscales, **mods),
                iters=ITERS, warmup=WARMUP)
        del mixed, decode
        torch.cuda.empty_cache()
    return dict(tree=tree, build_s=build_s, slowest=slowest, ms=ms)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--trees", nargs="+", help="checkouts to time, in this order")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--specs", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, json.loads(args.specs))))
        return 0
    here = os.path.realpath(os.getcwd())
    for tree in args.trees:
        if os.path.commonpath([os.path.realpath(tree), here]) != here:
            parser.error(f"{tree} lies outside the working directory; its build would be "
                         "deleted")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    specs = json.dumps(batch_specs())

    def turn(tree):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                              "--specs", specs], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            raise SystemExit(out.returncode)
        return json.loads(out.stdout.strip().splitlines()[-1])

    for tree in dict.fromkeys(args.trees):  # each tree's warm-up turn, untimed
        print(json.dumps(dict(turn(tree), warmup=True)), flush=True)
    runs = []
    for tree in args.trees:
        run = turn(tree)
        runs.append(run)
        print(json.dumps(run), flush=True)
    by_tree = {}
    for run in runs:
        by_tree.setdefault(run["tree"], []).append(run)
    first = args.trees[0]
    summary = {"card": card.strip(), "build_s": {}, "ms": {}, "change_pct": {}}
    for tree, tree_runs in by_tree.items():
        summary["build_s"][tree] = sum(r["build_s"] for r in tree_runs) / len(tree_runs)
        summary["ms"][tree] = {k: sum(r["ms"][k] for r in tree_runs) / len(tree_runs)
                               for k in tree_runs[0]["ms"]}
    for tree in by_tree:
        if tree != first:
            summary["change_pct"][tree] = {
                k: 100.0 * (v / summary["ms"][first][k] - 1.0)
                for k, v in summary["ms"][tree].items()}
            summary["change_pct"][tree]["build"] = 100.0 * (
                summary["build_s"][tree] / summary["build_s"][first] - 1.0)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A/B of forward kernel variants on one card.

    python tools/forward_kernel_ab.py smoke.json DIR_A DIR_B DIR_B DIR_A

Each DIR holds a copy of deeplearning4j_tpu_torch/csrc/ (one variant of
the kernels); smoke.json is the `--out` file of a chip_smoke.py run, whose
timing rows name the forward calls of a batch-32 forward and of a
batch-128 train step. For each DIR in the order given (parent, change,
change, parent), the forward kernels are built from it, checked against
their plain versions on every call's shape, and timed as chip_smoke.py
times them (inputs rotated past L2, CUDA graph replay); per-kernel sums
weighted by the calls' counts are printed per batch. Needs a CUDA card
and nvcc.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs
from deeplearning4j_tpu_torch.nn.helpers import kernel_build as kb
from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as pc


def main():
    rows = json.load(open(sys.argv[1]))
    keys = []
    for r in rows["timing_rows"] + rows["train_timing_rows"]:
        if not r["name"].startswith("fused"):
            continue
        f = [v == "True" for v in r["flags"]]
        keys.append(((r["name"], tuple(r["shape"]), torch.bfloat16, *f), r["count"],
                     "b32" if r in rows["timing_rows"] else "b128"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for v in sys.argv[2:]:
        d = Path(v).resolve()
        kb.CSRC_DIR, kb.BUILD_DIR = d, d / "_build"
        kb._libs.clear()
        (d / "_build").mkdir(exist_ok=True)
        for name in ("fused_conv1x1", "fused_conv3x3"):
            out = kb.library_path(name)
            if not out.exists():
                p = subprocess.run(kb._command(name, out), capture_output=True, text=True)
                if p.returncode:
                    print(v, name, "BUILD FAIL", p.stdout[-3000:], p.stderr[-3000:]); sys.exit(1)
                print(v, name, "C7515" if "C7515" in p.stdout + p.stderr else "no serialization warning")
        gen = torch.Generator(device="cuda").manual_seed(3)
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        sums = {}
        for key, count, which in keys:
            flops, nbytes, make, kern_f, plain_f, lib_f = cs.forward_case(torch, pc, r, key)
            ins = [make() for _ in range(cs.copies_for(nbytes))]
            a = ins[0]
            got, ref = kern_f(a), plain_f(a)
            torch.cuda.synchronize()
            err = cs.norm_err(got[0], ref[0])
            assert err <= 1e-2, (v, key, err)
            ms = cs.time_ms(torch, [lambda a=a: kern_f(a) for a in ins])
            del ins
            k = (key[0], which)
            sums[k] = sums.get(k, 0.0) + count * ms
            res.setdefault(v, []).append(ms)
            print(v, which, key[0][6:], key[1], "%.4f" % ms, "err %.1e" % err, flush=True)
        print(v, "SUMS", {f"{a[6:]} {b}": round(t, 4) for (a, b), t in sums.items()}, flush=True)


if __name__ == "__main__":
    main()

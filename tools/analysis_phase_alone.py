"""``chip_smoke.analysis_phase`` alone on the GPU machine, without the
training before it: the serving slice's seeded flagship run directory
(``chip_smoke.write_run``, grouped, full depth; its ``push_final`` also as
``nopush-group_last``, which ``threshold_save`` reads) analysed at
``push_final``.  ``--profile`` then runs ``analysis.nearest_img`` once
more under cProfile and prints its 25 most costly functions.

    python tools/analysis_phase_alone.py [--profile]

A dev script, no test tied to it; run it on the card.
"""

import argparse
import cProfile
import os
import pstats
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--profile", action="store_true")
    a = p.parse_args()
    t0 = time.perf_counter()
    smi = cs.device_phase()
    cs.log(smi)
    dev = torch.device("cuda")
    # the library defaults (TF32 on), as a user's process has them: the
    # phase enters each CLI so, and each turns TF32 off for its forwards
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        run = cs.write_run(tmp, seed=9, dev=dev)
        ck = os.path.join(run, "checkpoints")
        for ext in (".pth", ".ckpt.json"):
            shutil.copyfile(os.path.join(ck, "push_final" + ext),
                            os.path.join(ck, "nopush-group_last" + ext))
        cs.analysis_phase(tmp, "city_flagship", "push_final", dev, smi)
        if a.profile:
            from scaleprotoseg_torch.analysis import nearest_img
            os.environ.update(RESULTS_DIR=tmp, DATA_PATH_CITY=os.path.join(
                tmp, "analysis_city"))
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            prof = cProfile.Profile()
            prof.enable()
            nearest_img.main(["city_flagship", "push_final", "cityscapes"])
            torch.cuda.synchronize()
            prof.disable()
            pstats.Stats(prof).sort_stats("tottime").print_stats(25)
    cs.log(f"done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()

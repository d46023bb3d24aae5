"""Phases 1-8c of chip_smoke.py as its main() runs them, then phase 8c
twice with every collection of the garbage collector timed, and a full
collection timed after each pass. Prints lines that start with DIAG.

Needs the card. From the root of the repo:

    python3 tools/frontend_gc.py
"""
import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
import chip_smoke as c  # noqa: E402

t0 = time.perf_counter()
card = c.phase_device()
c.phase_build()
c.phase_parity()
c.phase_parity_training()
c.phase_parity_async()
c.phase_parity_ann()
c.phase_parity_backbone()
train = c.phase_training()
ev = c.phase_eval(train["L"], train["feats"], train["labels"])
c.phase_async_ps(train)
del train, ev
torch.cuda.empty_cache()
c.phase_fig4()
torch.cuda.empty_cache()
index, queries, serving, err = c.phase_serving()
c.phase_kernels(index, queries, serving["launches"], err)
built, ann = c.phase_ann(index, queries, serving)
c.time_ann(built, ann, queries)
c.phase_mutation(index, queries, serving, built, card)
print(f"DIAG before 8c at {time.perf_counter() - t0:.1f}s: objects "
      f"{len(gc.get_objects())}, counts {gc.get_count()}, thresholds "
      f"{gc.get_threshold()}, stats {gc.get_stats()}", flush=True)
for rep in range(2):
    cb, pauses = c._gc_pauses()
    c.phase_frontend(index, queries, serving, built, card)
    gc.callbacks.remove(cb)
    print(f"DIAG 8c pass {rep}: collections by generation "
          f"{c._gc_summary(pauses)}, those over 5 ms "
          f"{[(g, round(ms, 1)) for g, ms in pauses if ms > 5]}", flush=True)
    t = time.perf_counter()
    n = gc.collect()
    print(f"DIAG full collection after pass {rep}: "
          f"{(time.perf_counter() - t) * 1e3:.1f} ms, {n} unreachable, "
          f"objects {len(gc.get_objects())}", flush=True)
print("DIAG done", flush=True)

"""Nightly benchmark regression gate (port of
``benchmarks/check_thresholds.py``): the engine, campaign, planner,
collective-calibration, serving and kernel benches of
``repro_torch.bench`` held to the reference's thresholds, with its
``PASS``/``FAIL``/``SKIP`` lines and exit code 1 on any failure.

The gate is split in two: :func:`collect` runs the benches and returns
their results, :func:`evaluate` holds results to the thresholds and
returns the failures, so that a caller that already holds the results
(``chip_smoke.py``'s benches phase) gates them without running the
benches twice.  The thresholds are the reference's, unchanged: they were
set on a host-CPU model (the serving bench's reduced internlm2, 500 ms a
token for goodput); on the card the benches phase serves full-width
internlm2-1.8b and every condition is stated as the reference states it,
its number printed beside it.

It enforces:

* engine batched-vs-scalar speedup ≥ ``ENGINE_SPEEDUP_MIN`` (acceptance
  target is 5×; the gate is laxer to absorb CI-runner noise),
* batched/scalar prediction parity is exact,
* calibrated accuracy on the golden fixture: phi MAPE ≤ 0.25, gamma
  MAPE ≤ 0.10 (the fitted targets are 0.15 / 0.04),
* cost-ledger parity (docs/engine.md "Cost ledger"): per-op class sums
  reproduce the HloCost scalars (relative 1e-9; exact at smoke scale), on
  a compiled golden program and on the campaign records' recorded
  breakdowns, and the APPLIED class-wise
  calibration (CNN and campaign HLO fits both) is never worse than the
  aggregate 3-term fallback,
* energy (docs/engine.md "Energy"): the priced ledger's per-class joule
  sums reproduce its aggregate (same relative 1e-9), and the applied
  energy fit (CNN calibration and campaign HLO both) is never worse than
  the tied-aggregate fallback,
* campaign LM-forest accuracy (docs/campaign.md): held-out-cell latency
  MAPE and combined latency+memory MAPE from the campaign-fitted forest
  beat the uncalibrated analytical path on the host-CPU smoke grid,
* serving (docs/serve.md): on the seeded mixed-length Poisson trace the
  continuous-batching engine sustains at least the lockstep engine's
  req/s at equal ``n_slots`` (speedup ≥ ``SERVE_SPEEDUP_MIN``), records
  finite p50/p99 TTFT and per-token latency, its goodput is never worse,
  and the paged KV pool is smaller than the dense cache it replaced,
* chunked prefill (docs/serve.md): greedy streams identical with and
  without chunking, decode never stalls, the running-slot stall bound
  drops from the whole prompt to one chunk, and deterministic step-count
  TTFT p99 degrades at most 10%,
* per kernel (incl. the moe_dispatch model), the autotuned config's
  modelled roofline time is never worse than the hand-coded default (the
  default is a candidate, so any violation means the cost model or
  search broke),
* paged_decode (docs/kernels.md): the tuned flash-decode kernel is never
  modelled slower than the XLA gather fallback at the serving shape, and
  the serve_kv pool block jointly admits the kernel's tuned block_kv,
* a second autotune pass over the bench grid is a pure cache hit.

Exit code 1 with a FAIL line per violated threshold.

    PYTHONPATH=src python -m repro_torch.bench.check_thresholds [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys

__all__ = ["collect", "evaluate", "main"]

ENGINE_SPEEDUP_MIN = 3.0
PHI_MAPE_MAX = 0.25
GAMMA_MAPE_MAX = 0.10
PARITY_TOL = 1e-9   # packed-forest float accumulation order (≈1e-14 observed)
# Class-grouped vs sequential ledger sums: relative, since addition
# reordering is only bit-exact below the 2^53 integer ceiling (0 observed
# at smoke scale).
LEDGER_PARITY_RTOL = 1e-9
CAMPAIGN_GAMMA_MAPE_MAX = 0.50  # sanity bound on the LM forest's memory error
PLANNER_WALL_S_MAX = 1.0        # price the whole layout space, zero compiles
COLLECTIVE_CELLS_MIN = 2        # >1-device smoke cells the NNLS must see
SERVE_SPEEDUP_MIN = 1.0         # continuous must never lose to lockstep
# Under the seeded chaos plan the engine must keep a usable fraction of
# its fault-free goodput (lax: CI wall-clock noise dominates the rest).
CHAOS_GOODPUT_RATIO_MIN = 0.25
# Chunked prefill: gated on the deterministic step-count
# metrics (wall-clock ratios are reported but too noisy to gate on a
# shared CI host).  TTFT in engine steps may degrade at most 10%.
CHUNKED_TTFT_STEPS_RATIO_MAX = 1.10
# The tuned paged_decode kernel must never be modelled slower than the
# gather fallback at the serving bench shape.
PAGED_DECODE_VS_GATHER_MIN = 1.0



def collect(print_fn=print, *, device="cuda", cfg=None, params=None) -> dict:
    """Run every bench the gate reads, on ``device`` (default ``cuda``;
    raises without a card unless ``"cpu"``); the serving benches on
    ``cfg``/``params`` when given (else their reduced model)."""
    from repro_torch.bench import engine_bench, kernel_bench, serve_bench

    serve_kw = {"device": device, "cfg": cfg, "params": params}
    return {
        "engine": engine_bench.run(print_fn, device=device),
        "campaign": engine_bench.campaign_accuracy(print_fn, device=device),
        "planner": engine_bench.planner_bench(print_fn),
        "collective": engine_bench.collective_calibration(print_fn),
        "serve": serve_bench.run(print_fn, **serve_kw),
        "chunked": serve_bench.run_chunked(print_fn, **serve_kw),
        "chaos": serve_bench.run_chaos(print_fn, **serve_kw),
        "kernel": kernel_bench.run(print_fn, device=device),
    }


def evaluate(results: dict, print_fn=print) -> list[str]:
    """Hold :func:`collect`'s results to the thresholds: one ``PASS`` or
    ``FAIL`` line per condition (``SKIP`` where the reference skips);
    returns the failed conditions."""
    from repro_torch.bench.serve_bench import PREFILL_CHUNK

    failures: list[str] = []

    def check(ok: bool, msg: str) -> None:
        print_fn(("PASS " if ok else "FAIL ") + msg)
        if not ok:
            failures.append(msg)

    eng = results["engine"]
    check(eng["speedup"] >= ENGINE_SPEEDUP_MIN,
          f"engine batched speedup {eng['speedup']:.1f}x >= {ENGINE_SPEEDUP_MIN}x")
    check(eng["max_dev"] <= PARITY_TOL,
          f"engine batched/scalar parity dev {eng['max_dev']:.3g} <= {PARITY_TOL}")
    # Cost-ledger contract: per-op class sums reproduce the HloCost scalars
    # on a compiled golden program.
    check(eng["ledger_parity_dev"] <= LEDGER_PARITY_RTOL,
          f"cost-ledger breakdown parity rel dev "
          f"{eng['ledger_parity_dev']:.3g} <= {LEDGER_PARITY_RTOL}")
    # Energy obeys the same contract: per-class joule sums reproduce the
    # priced ledger's aggregate (docs/engine.md "Energy").
    check(eng["ledger_energy_parity_dev"] <= LEDGER_PARITY_RTOL,
          f"cost-ledger energy parity rel dev "
          f"{eng['ledger_energy_parity_dev']:.3g} <= {LEDGER_PARITY_RTOL}")
    if "phi_mape_cal" in eng:  # golden fixture present
        check(eng["phi_mape_cal"] <= PHI_MAPE_MAX,
              f"calibrated phi MAPE {eng['phi_mape_cal']:.3f} <= {PHI_MAPE_MAX}")
        check(eng["gamma_mape_cal"] <= GAMMA_MAPE_MAX,
              f"calibrated gamma MAPE {eng['gamma_mape_cal']:.3f} <= {GAMMA_MAPE_MAX}")
        # Class-wise calibration must never be worse than the 3-term
        # aggregate fit (the aggregate is the tied-coefficient special
        # case, and calibrate() falls back when the split carries nothing).
        check(eng["phi_mape_cal"] <= eng["phi_mape_cal_aggregate"] * (1 + 1e-9),
              f"class-wise phi MAPE {eng['phi_mape_cal']:.3f} <= aggregate "
              f"{eng['phi_mape_cal_aggregate']:.3f}")
        if "energy_mape_cal" in eng:
            # Same never-worse contract for the energy fit: the applied
            # (lower-MAPE) fit can never lose to the tied aggregate.
            check(eng["energy_mape_cal"]
                  <= eng["energy_mape_cal_aggregate"] * (1 + 1e-9),
                  f"applied energy MAPE {eng['energy_mape_cal']:.3f} <= "
                  f"aggregate {eng['energy_mape_cal_aggregate']:.3f}")
    else:
        print_fn("SKIP calibration accuracy (golden fixture absent)")

    # Campaign LM-forest accuracy: the campaign-fitted
    # forest must beat the uncalibrated analytical path on held-out smoke
    # cells — individually on latency, and on the combined latency+memory
    # error (analytical memory is derived from a real AOT compile, so it is
    # near ground truth; the forest's win there is paying zero compiles).
    camp = results["campaign"]
    if camp:
        check(camp["forest_phi_mape"] < camp["analytical_phi_mape"],
              f"campaign forest phi MAPE {camp['forest_phi_mape']:.3f} < "
              f"analytical {camp['analytical_phi_mape']:.3f} "
              f"(heldout n={camp['n_heldout']})")
        forest_total = camp["forest_phi_mape"] + camp["forest_gamma_mape"]
        anal_total = camp["analytical_phi_mape"] + camp["analytical_gamma_mape"]
        check(forest_total < anal_total,
              f"campaign forest phi+gamma MAPE {forest_total:.3f} < "
              f"analytical {anal_total:.3f}")
        check(camp["forest_gamma_mape"] <= CAMPAIGN_GAMMA_MAPE_MAX,
              f"campaign forest gamma MAPE {camp['forest_gamma_mape']:.3f} "
              f"<= {CAMPAIGN_GAMMA_MAPE_MAX}")
        if "breakdown_parity_dev" in camp:
            check(camp["breakdown_parity_dev"] <= LEDGER_PARITY_RTOL,
                  f"campaign ledger breakdown parity rel dev "
                  f"{camp['breakdown_parity_dev']:.3g} <= {LEDGER_PARITY_RTOL}")
        if "hlo_phi_mape_applied" in camp:
            check(camp["hlo_phi_mape_applied"]
                  <= camp["hlo_phi_mape_aggregate"] * (1 + 1e-9),
                  f"campaign applied HLO phi MAPE "
                  f"{camp['hlo_phi_mape_applied']:.3f} <= aggregate "
                  f"{camp['hlo_phi_mape_aggregate']:.3f}")
        if "hlo_energy_mape_applied" in camp:
            check(camp["hlo_energy_mape_applied"]
                  <= camp["hlo_energy_mape_aggregate"] * (1 + 1e-9),
                  f"campaign applied HLO energy MAPE "
                  f"{camp['hlo_energy_mape_applied']:.3f} <= aggregate "
                  f"{camp['hlo_energy_mape_aggregate']:.3f}")
    else:
        print_fn("SKIP campaign accuracy (smoke grid too sparse)")

    # Auto-sharding planner (docs/planner.md): the
    # chosen layout's predicted step cost is never worse than the
    # hard-coded production mesh (1x16x16 — which is itself a candidate,
    # so any violation means the ranking broke), the FULL layout space is
    # priced well under a second, and the booby-trapped compiler counted
    # zero invocations while it happened.
    pl = results["planner"]
    check(pl["compiles"] == 0,
          f"planner priced {pl['layouts']} layouts with zero compiles "
          f"(counted {pl['compiles']})")
    check(pl["chosen_phi_ms"] <= pl["default_phi_ms"] * (1 + 1e-9),
          f"planner chosen {pl['chosen']} phi {pl['chosen_phi_ms']:.2f}ms <= "
          f"default 1x16x16 phi {pl['default_phi_ms']:.2f}ms "
          f"(speedup {pl['speedup']:.2f}x)")
    check(pl["wall_s"] < PLANNER_WALL_S_MAX,
          f"planner pricing wall {pl['wall_s'] * 1e3:.1f}ms < "
          f"{PLANNER_WALL_S_MAX * 1e3:.0f}ms")

    # Collective calibration (the >1-device smoke grid): after the fit,
    # the collective column must have entered the class-wise system on
    # real multi-device measurements — the coefficient the planner's
    # collective_seconds() prices layouts with.
    coll = results["collective"]
    if coll:
        check(coll["collective_cells"] >= COLLECTIVE_CELLS_MIN,
              f"collective calibration saw {coll['collective_cells']} "
              f">1-device cells >= {COLLECTIVE_CELLS_MIN}")
        check(bool(coll["collective_column_fitted"]),
              f"collective coeffs present after smoke fit "
              f"(coeff={coll['collective_coeff']:.3g} s/B, "
              f"n={coll['n_records']} records)")
    else:
        print_fn("SKIP collective calibration (subprocess or fit unavailable)")

    # Serving: continuous batching vs lockstep on the seeded open-loop
    # trace — never worse on sustained req/s or
    # goodput, latency percentiles recorded and finite, paged pool
    # strictly smaller than the dense cache it replaced.
    srv = results["serve"]
    check(srv["speedup"] >= SERVE_SPEEDUP_MIN,
          f"serve continuous {srv['continuous_rps']:.2f} req/s >= lockstep "
          f"{srv['lockstep_rps']:.2f} req/s "
          f"(speedup {srv['speedup']:.2f}x >= {SERVE_SPEEDUP_MIN}x)")
    check(all(math.isfinite(srv[k]) and srv[k] > 0 for k in
              ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms")),
          f"serve latency percentiles recorded "
          f"(ttft p50/p99 {srv['ttft_p50_ms']:.2f}/{srv['ttft_p99_ms']:.2f}ms, "
          f"tpot p50/p99 {srv['tpot_p50_ms']:.2f}/{srv['tpot_p99_ms']:.2f}ms)")
    check(srv["goodput_continuous"] >= srv["goodput_lockstep"],
          f"serve goodput continuous {srv['goodput_continuous']:.2f} >= "
          f"lockstep {srv['goodput_lockstep']:.2f} req/s")
    check(srv["kv_bytes"] < srv["kv_dense_bytes"],
          f"paged KV pool {srv['kv_bytes'] / 1e6:.3g}MB < dense "
          f"{srv['kv_dense_bytes'] / 1e6:.3g}MB (block={srv['block_size']})")

    # Chunked prefill: greedy streams identical to
    # the unchunked engine, decode never stalls, the running-slot stall
    # bound drops from the whole prompt to one chunk, and step-count TTFT
    # p99 degrades at most 10%.  All gated quantities are deterministic.
    chk = results["chunked"]
    check(chk["streams_equal"],
          "serve chunked greedy streams identical to unchunked")
    check(chk["chunked"]["prefill_chunks"] > 0,
          f"serve chunked prefill actually chunked "
          f"({chk['chunked']['prefill_chunks']} chunks of "
          f"{PREFILL_CHUNK})")
    check(chk["chunked"]["max_decode_stall_steps"] == 0,
          f"serve chunked decode never stalls "
          f"(max stall {chk['chunked']['max_decode_stall_steps']} steps)")
    check(chk["chunked"]["lost"] == 0 and chk["unchunked"]["lost"] == 0,
          "serve chunked zero lost requests")
    check(chk["chunked"]["max_prefill_stall_tokens"]
          < chk["unchunked"]["max_prefill_stall_tokens"],
          f"serve chunked running-slot stall bound "
          f"{chk['chunked']['max_prefill_stall_tokens']} tokens < unchunked "
          f"{chk['unchunked']['max_prefill_stall_tokens']} (one chunk, "
          f"not the whole prompt)")
    check(chk["ttft_steps_ratio"] <= CHUNKED_TTFT_STEPS_RATIO_MAX,
          f"serve chunked step-TTFT p99 ratio "
          f"{chk['ttft_steps_ratio']:.3f} <= {CHUNKED_TTFT_STEPS_RATIO_MAX} "
          f"(chunked {chk['chunked']['ttft_steps_p99']:.1f} vs unchunked "
          f"{chk['unchunked']['ttft_steps_p99']:.1f} steps)")
    check(0 < chk["chunked"]["kv_touched_bytes"]
          < chk["chunked"]["kv_gathered_bytes"],
          f"serve chunked decode kernel touches "
          f"{chk['chunked']['kv_touched_bytes'] / 1e6:.1f}MB < gather's "
          f"{chk['chunked']['kv_gathered_bytes'] / 1e6:.1f}MB logical view")

    # Chaos: under the seeded fault plan no request
    # is lost (all reach a typed terminal state), the planned faults
    # actually fired, the pool conserves, and goodput under faults holds
    # a floor fraction of the identical fault-free cell's.
    chaos = results["chaos"]
    check(chaos["chaos_lost"] == 0 and chaos["baseline_lost"] == 0,
          f"serve chaos zero lost requests "
          f"(chaos={chaos['chaos_lost']}, baseline={chaos['baseline_lost']})")
    check(chaos["chaos_terminal"] == chaos["n_requests"],
          f"serve chaos all terminal "
          f"({chaos['chaos_terminal']}/{chaos['n_requests']}: "
          f"{chaos['chaos_finished']} finished, {chaos['chaos_refused']} "
          f"refused, {chaos['chaos_expired']} expired)")
    check(chaos["faults_alloc_fired"] > 0 and chaos["faults_backend_fired"] > 0,
          f"serve chaos faults actually fired "
          f"(alloc={chaos['faults_alloc_fired']}, "
          f"backend={chaos['faults_backend_fired']})")
    check(chaos["pool_conserved"],
          "serve chaos KV pool fully reclaimed after drain")
    check(chaos["goodput_ratio"] >= CHAOS_GOODPUT_RATIO_MIN,
          f"serve chaos goodput {chaos['goodput_chaos']:.2f} req/s >= "
          f"{CHAOS_GOODPUT_RATIO_MIN} x fault-free "
          f"{chaos['goodput_faultfree']:.2f} req/s "
          f"(ratio {chaos['goodput_ratio']:.2f})")

    kern = results["kernel"]
    for name in ("conv_mm", "flash_attention", "ssm_scan", "moe_dispatch",
                 "paged_decode"):
        r = kern[name]
        check(r["tuned_us"] <= r["default_us"] * (1 + 1e-9),
              f"{name} tuned model {r['tuned_us']:.2f}us <= "
              f"default {r['default_us']:.2f}us ({r['config']})")
    # Flash-decode fast path: the tuned paged_decode kernel is
    # never modelled slower than the XLA gather fallback at the serving
    # shape, and the serve_kv pool block jointly admits the kernel's
    # tuned block_kv (divisibility — no mid-block remainder handling).
    check(kern["paged_decode"]["vs_gather"] >= PAGED_DECODE_VS_GATHER_MIN,
          f"paged_decode tuned {kern['paged_decode']['tuned_us']:.2f}us "
          f"beats gather {kern['paged_decode']['gather_us']:.2f}us "
          f"({kern['paged_decode']['vs_gather']:.2f}x >= "
          f"{PAGED_DECODE_VS_GATHER_MIN}x)")
    check(kern["serve_kv_joint"]["aligned"],
          f"serve_kv block_size {kern['serve_kv_joint']['block_size']} "
          f"admits paged_decode block_kv "
          f"{kern['serve_kv_joint']['block_kv']} (joint resolution)")
    check(kern["second_call_hits"] == 6 and kern["second_call_misses"] == 0,
          f"autotune second pass pure cache hit "
          f"({kern['second_call_hits']} hits, {kern['second_call_misses']} misses)")

    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the benches run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    failures = evaluate(collect(device=args.device))
    if failures:
        print(f"\n{len(failures)} threshold(s) violated")
        return 1
    print("\nall benchmark thresholds met")
    return 0


if __name__ == "__main__":
    sys.exit(main())

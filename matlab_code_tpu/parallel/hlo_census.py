"""Compiled-HLO structural audit of the ring-pipelined MTTKRP.

One shared implementation for both consumers — tests/test_shard_mttkrp.py's
HLO-structure test and bench_scaling.py's SCALING-artifact census — so the
regexes and assertions cannot drift apart (they encode the overlap design
of parallel/shard_mttkrp.make_sharded_mttkrp_pipelined and must evolve with
it and with the HLO text format together).
"""
from __future__ import annotations

import re


def ring_permute_census(txt: str, n: int) -> dict:
    """Audit the compiled-HLO text of ONE pipelined ring at ring size n.

    Checks the overlap design: n-1 collective-permute sites per ring
    (sync form, or async start/done pairs on backends whose scheduler
    splits collectives, such as the GPU's; the CPU backend lowers them
    synchronously), at least one all-gather (the tiled factor
    re-replication), and dataflow independence — every permute result is
    consumed JOINTLY WITH a dot/fusion that is not downstream of it
    (fusion(%permute, %dot) / add(%permute, %dot)), never BY the next
    chunk's contraction, so the scheduler may hide the transfer behind the
    compute.  Raises AssertionError on any structural violation; returns
    the site counts for artifact reporting.
    """
    sync = len(re.findall(r"= [^=]*collective-permute\(", txt))
    starts = len(re.findall(r"collective-permute-start\(", txt))
    dones = len(re.findall(r"collective-permute-done\(", txt))
    gathers = len(re.findall(r"all-gather", txt))
    consumers = re.findall(
        r"= \S+ (?:fusion|add)\(([^)]*(?:collective-permute|ppermute)"
        r"[^)]*)\)", txt)
    overlap_ok = bool(consumers) and all(
        ("dot" in a or "fusion" in a) for a in consumers)
    assert starts == dones, (starts, dones)
    assert sync + starts == n - 1, (n, sync, starts)
    assert gathers >= 1, "no all-gather site in the pipelined ring"
    assert overlap_ok, consumers[:3]
    return {"ring_steps": n - 1, "permute_sites_sync": sync,
            "permute_start_done_pairs": starts,
            "all_gather_sites": gathers,
            "overlap_dataflow_independent": overlap_ok}

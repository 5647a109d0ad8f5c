"""The port's race sanitizer: unit contracts, the port's threaded paths,
and the same verdicts as the reference's sanitizer.

Unit half: ``repro_torch.analysis.racecheck.LockRegistry`` reports
unguarded writes, detects lock-order cycles, tolerates RLock re-entrancy,
backs a ``threading.Condition`` and restores ``__setattr__`` on close.

Threaded half, on the CPU under the port's registry (the ``torch_racecheck``
fixture of ``tests/_torch_racecheck.py`` fails a test on any report or cycle at teardown): admission
serving with concurrent submitters, the ingest pump, the chaos proxy's
failure counter, concurrent CMDB registration and the port's
``ChaosReplay``, with live ingestion and threaded serving run together.

Held against the reference: the same scripted acquisition and write
sequences, fed to ``repro.analysis.racecheck.LockRegistry`` and to the
port's, give equal ``edges()``, ``cycles()`` and ``problems()``.  The
scripts are drawn from seeded numpy generators.
"""
import threading
import time

import numpy as np
import pytest

from repro.analysis import racecheck as ref_racecheck
from repro_torch.analysis import racecheck
from repro_torch.analysis.racecheck import (LockRegistry,
                                            instrument_admission_queue,
                                            instrument_cmdb,
                                            instrument_fault_server,
                                            instrument_pump,
                                            instrument_server)
from repro_torch.core import EngineConfig, ResourceRequest
from repro_torch.core.types import Recommendation
from repro_torch.operator import ChaosReplay
from repro_torch.operator.chaos import FaultInjectedServer
from repro_torch.operator.cmdb import PoolCMDB
from repro_torch.serve import BatchServer, DeviceArchive
from repro_torch.stream import AdmissionQueue, IngestPump

from _torch_racecheck import torch_racecheck  # noqa: F401
from test_torch_operator import PORT as OPERATOR_PORT
from test_torch_operator import _full_menu
from test_torch_stream import _pump_world, synth_candidates

CPU = "cpu"


class Counter:
    def __init__(self):
        self.n = 0


# ---------------------------------------------------------------------------
# registry unit contracts
# ---------------------------------------------------------------------------

def test_unguarded_write_is_reported():
    reg = LockRegistry()
    try:
        lock = reg.wrap(threading.Lock(), "c.lock")
        c = Counter()
        reg.guard(c, fields=("n",), locks=("c.lock",), label="Counter")
        with lock:
            c.n += 1                      # under the mapped lock: clean
        assert reg.race_reports() == []
        c.n += 1                          # off-lock: one report
        (rep,) = reg.race_reports()
        assert rep.obj == "Counter" and rep.attr == "n"
        assert "unguarded write" in rep.format()
        assert reg.problems() and c.n == 2    # the write still lands
        with pytest.raises(AssertionError, match="racecheck"):
            reg.assert_clean()
    finally:
        reg.close()


def test_lock_order_cycle_detected():
    reg = LockRegistry()
    a = reg.wrap(threading.Lock(), "A")
    b = reg.wrap(threading.Lock(), "B")
    with a:
        with b:
            pass
    with b:
        with a:                           # inverted order: A->B and B->A
            pass
    (cycle,) = reg.cycles()
    assert set(cycle) == {"A", "B"}
    assert any("deadlock" in p for p in reg.problems())


def test_consistent_lock_order_is_clean():
    reg = LockRegistry()
    a = reg.wrap(threading.Lock(), "A")
    b = reg.wrap(threading.Lock(), "B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert reg.edges() == [("A", "B")]
    assert reg.cycles() == [] and reg.problems() == []


def test_rlock_reentrancy_orders_nothing():
    reg = LockRegistry()
    r = reg.wrap(threading.RLock(), "R")
    with r:
        with r:
            assert reg.held_now() == ("R", "R")
    assert reg.held_now() == ()
    assert reg.edges() == [] and reg.problems() == []


def test_condition_over_instrumented_lock():
    # the admission queue's _wake shape: Condition sharing the queue lock
    reg = LockRegistry()
    lock = reg.wrap(threading.Lock(), "q.lock")
    cond = threading.Condition(lock)
    box = []

    def waiter():
        with cond:
            while not box:
                if not cond.wait(timeout=10.0):
                    return
            box.append("woke")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        box.append("signal")
        cond.notify()
    t.join(10.0)
    assert not t.is_alive() and "woke" in box
    assert reg.problems() == []


def test_close_restores_setattr():
    reg = LockRegistry()
    c = Counter()
    orig = type(c).__setattr__
    reg.guard(c, fields=("n",), locks=("never-held",))
    assert type(c).__setattr__ is not orig
    reg.close()
    c.n += 5                              # unpatched again: no report
    assert reg.race_reports() == []
    assert type(c).__setattr__ is orig


def test_failed_nonblocking_acquire_records_nothing():
    # the Condition ownership probe: a failed try-acquire holds nothing
    reg = LockRegistry()
    a = reg.wrap(threading.Lock(), "A")
    b = reg.wrap(threading.Lock(), "B")
    got = []
    with b:
        t = threading.Thread(target=lambda: got.append(b.acquire(False)))
        t.start()
        t.join(10.0)
        assert a.acquire(False)
        a.release()
    assert got == [False] and reg.held_now() == ()
    assert reg.edges() == [("B", "A")]


# ---------------------------------------------------------------------------
# the reference's and the port's registries on the same scripts
# ---------------------------------------------------------------------------

LOCKS = ("A", "B", "C", "R")


def _script(seed: int) -> list:
    """Per thread, a list of steps: ``("nest", [lock names])`` takes the
    locks nested in that order (``R`` is an RLock and may repeat), and
    ``("write", held)`` writes a guarded field holding the lock ``held``
    (or none).  Every third seed keeps the discipline: one global lock
    order, and every write under a guarding lock."""
    rng = np.random.default_rng(seed)
    disciplined = seed % 3 == 0
    threads = []
    for _ in range(int(rng.integers(2, 5))):
        steps = []
        for _ in range(int(rng.integers(2, 7))):
            if rng.random() < 0.7:
                depth = int(rng.integers(1, 4))
                order = [str(x) for x in rng.choice(LOCKS, depth,
                                                    replace=False)]
                if disciplined:
                    order.sort(key=LOCKS.index)
                if "R" in order and rng.random() < 0.5:
                    order.append("R")             # re-entrant RLock take
                steps.append(("nest", order))
            else:
                held = rng.choice(["A", "C"] if disciplined
                                  else ["A", "B", None])
                steps.append(("write", None if held is None else str(held)))
        threads.append(steps)
    return threads


def _play(module, script) -> tuple:
    class Guarded:
        def __init__(self):
            self.n = 0

    reg = module.LockRegistry()
    try:
        locks = {name: reg.wrap(threading.RLock() if name == "R"
                                else threading.Lock(), name)
                 for name in LOCKS}
        obj = Guarded()
        reg.guard(obj, fields=("n",), locks=("A", "C"), label="Guarded")

        def nest(order):
            if not order:
                return
            with locks[order[0]]:
                nest(order[1:])

        def run(steps):
            for kind, arg in steps:
                if kind == "nest":
                    nest(arg)
                elif arg is None:
                    obj.n += 1
                else:
                    with locks[arg]:
                        obj.n += 1

        for i, steps in enumerate(script):
            t = threading.Thread(target=run, args=(steps,),
                                 name=f"scripted-{i}")
            t.start()
            t.join(10.0)
            assert not t.is_alive()
        return reg.edges(), reg.cycles(), reg.problems()
    finally:
        reg.close()


@pytest.mark.parametrize("seed", range(12))
def test_both_registries_give_equal_verdicts(seed):
    script = _script(seed)
    ours = _play(racecheck, script)
    theirs = _play(ref_racecheck, script)
    assert ours == theirs


def test_scripts_reach_cycles_and_reports():
    # the seeds above are not all clean: both verdicts are exercised
    verdicts = [_play(racecheck, _script(s)) for s in range(12)]
    assert any(cycles for _, cycles, _ in verdicts)
    assert any(any("unguarded" in p for p in problems)
               for _, _, problems in verdicts)
    assert any(not problems for _, _, problems in verdicts)


# ---------------------------------------------------------------------------
# threaded integration over the port's objects, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cands():
    return synth_candidates(seed=11, K=32, T=12)


def test_threaded_admission_serving_is_race_free(torch_racecheck, cands):
    server = BatchServer(bucket_sizes=(1, 4, 16), config=EngineConfig(),
                         device=CPU)
    q = AdmissionQueue(server, DeviceArchive.stage(cands, device=CPU),
                       max_wait_s=0.01, max_pending=64)
    instrument_server(torch_racecheck, server)
    instrument_admission_queue(torch_racecheck, q)
    q.start()
    try:
        def client(i):
            for j in range(5):
                t = q.submit(ResourceRequest(cpus=float(8 * (1 + (i + j) % 4))))
                t.result(timeout=60.0)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        q.stop()
    assert q.stats.submitted == 20 and q.stats.served == 20
    assert server.stats.requests == 20
    assert torch_racecheck.edges() == []   # no lock held across another
    assert torch_racecheck.problems() == []


def test_ingest_pump_is_race_free(torch_racecheck):
    _, _, ing, collect = _pump_world()
    pump = IngestPump(ing, collect)
    instrument_pump(torch_racecheck, pump)
    v0 = ing.version
    with pump:
        deadline = time.monotonic() + 30.0
        while pump.ticks_pumped < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert pump.ticks_pumped >= 3 and pump.errors == 0
    assert pump.ticks_pumped == ing.version - v0
    assert torch_racecheck.problems() == []


def test_pump_and_admission_worker_together_are_race_free(torch_racecheck):
    """Live ingestion and threaded serving at once: the pump appends while
    the admission worker drains snapshots and a direct caller serves."""
    _, _, ing, collect = _pump_world()
    server = BatchServer(bucket_sizes=(1, 4, 16), device=CPU)
    q = AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.005)
    pump = IngestPump(ing, collect)
    instrument_server(torch_racecheck, server)
    instrument_admission_queue(torch_racecheck, q)
    instrument_pump(torch_racecheck, pump)
    v0 = ing.version
    recs, direct = [], []
    lock = threading.Lock()

    def client(i):
        tickets = [q.submit(ResourceRequest(cpus=float(16 * (1 + (i + j) % 5))))
                   for j in range(4)]
        got = [t.result(timeout=60.0) for t in tickets]
        with lock:
            recs.extend(got)

    def caller():
        for _ in range(3):
            direct.extend(server.serve(ing.archive.snapshot(),
                                       [ResourceRequest(cpus=64.0)]))

    q.start()
    try:
        with pump:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(4)]
            threads.append(threading.Thread(target=caller))
            for t in threads:
                t.start()
            for t in threads:
                t.join(120.0)
            deadline = time.monotonic() + 30.0
            while pump.ticks_pumped < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
    finally:
        q.stop()
    assert not any(t.is_alive() for t in threads)
    assert len(recs) == 16 and len(direct) == 3
    assert all(r.hourly_cost > 0 for r in recs + direct)
    assert q.stats.served == 16 and server.stats.requests == 19
    assert pump.errors == 0 and pump.ticks_pumped == ing.version - v0 >= 3
    assert torch_racecheck.problems() == []


def test_fault_injected_counter_is_race_free(torch_racecheck):
    fs = FaultInjectedServer(object())    # armed path never touches it
    instrument_fault_server(torch_racecheck, fs)
    fs.armed = True
    hits = []

    def hammer():
        got = 0
        for _ in range(25):
            try:
                fs.serve(None, [])
            except RuntimeError:
                got += 1
        hits.append(got)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert sum(hits) == 100 and fs.injected_failures == 100
    assert torch_racecheck.problems() == []


class _FakeItem:
    vcpus = 8.0
    memory_gb = 64.0


class _FakeCatalog:
    def get(self, name):
        return _FakeItem()


def _rec():
    one = np.asarray([1.0])
    return Recommendation(
        names=np.asarray(["m5.2xlarge"]), regions=np.asarray(["us-east-1"]),
        azs=np.asarray(["a"]), counts=one, combined=one,
        availability=np.asarray([90.0]), cost=one, hourly_cost=0.5)


def test_cmdb_concurrent_registration_is_race_free(torch_racecheck):
    cmdb = PoolCMDB(_FakeCatalog())
    instrument_cmdb(torch_racecheck, cmdb)

    def register(i):
        for j in range(10):
            cmdb.record_issued(ResourceRequest(cpus=float(8 * (i * 10 + j))),
                               _rec(), now=float(j))

    threads = [threading.Thread(target=register, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert len(cmdb) == 40                # every distinct signature tracked
    assert cmdb.n_interruptions() == 0
    assert torch_racecheck.problems() == []


def test_chaos_replay_is_race_free(torch_racecheck):
    rep = ChaosReplay(seed=7, n_targets=24, window=6, warmup_cycles=6,
                      cycles=8, schedule=_full_menu(OPERATOR_PORT),
                      device=CPU)
    instrument_server(torch_racecheck, rep.server)
    instrument_fault_server(torch_racecheck, rep.faulty)
    instrument_admission_queue(torch_racecheck, rep.queue)
    instrument_cmdb(torch_racecheck, rep.operator.cmdb)
    report = rep.run("racecheck")
    assert report.stranded_tickets == 0 and report.worker_alive_at_end
    assert report.failed_drains >= 1 and rep.faulty.injected_failures >= 1
    assert torch_racecheck.problems() == []


def test_negative_controls_fire_on_port_objects():
    """What the card run's negative controls check: an off-lock write to
    a guarded ``ServeStats`` counter gives one report naming it, and two
    locks taken in opposite orders give one cycle."""
    reg = LockRegistry()
    try:
        server = BatchServer(bucket_sizes=(1,), device=CPU)
        instrument_server(reg, server)
        t = threading.Thread(target=lambda: setattr(
            server.stats, "requests", server.stats.requests + 1),
            name="unguarded")
        t.start()
        t.join(10.0)
        (rep,) = reg.race_reports()
        assert (rep.obj, rep.attr, rep.thread) == ("ServeStats", "requests",
                                                   "unguarded")
        assert reg.cycles() == []
    finally:
        reg.close()
    reg = LockRegistry()
    a = reg.wrap(threading.Lock(), "a")
    b = reg.wrap(threading.Lock(), "b")
    for first, second in ((a, b), (b, a)):
        t = threading.Thread(target=lambda x=first, y=second: (
            x.acquire(), y.acquire(), y.release(), x.release()))
        t.start()
        t.join(10.0)
    assert len(reg.cycles()) == 1 and reg.race_reports() == []

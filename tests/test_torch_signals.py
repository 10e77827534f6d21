"""The wait and store order of K3 and K4, modelled on the CPU.

K3 (``kernels/csrc/fused.cu``) and K4 (``kernels/csrc/onesided.cu``) run
only on the card, where a task waits on 64-bit words that carry a tag (the
timestep that wrote them, plus one) beside their value
(``kernels/csrc/signal.cuh``).  Here the same order of waits and stores
runs in Python: each CTA is a generator that yields at every poll and every
store, and a seeded random scheduler moves one CTA at a time, each CTA at a
speed of its own, so CTAs interleave in orders a card may take (all of them
resident, as the cooperative launch guarantees, but at any relative pace).

Held, for every pattern, on the tables ``MegakernelBackend`` builds:

- no deadlock (the scheduler fails when every live CTA polls a word that no
  store can write any more);
- every word read carries the tag its reader waited for, and no word is
  written twice;
- the final wave equals the kernel's plain version bitwise.

K3 runs 1 and 3 stacked graphs, with a CTA a task and with fewer CTAs than
tasks (the grid-stride case); K4 runs at 2, 4 and 8 ranks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backends import body  # noqa: E402
from repro_torch.backends.megakernel import (  # noqa: E402
    MegakernelBackend, onesided_tables_from_numpy, tables_from_numpy,
    taskbench_fused_plain, taskbench_onesided_plain)
from repro_torch.core import make_graph, pattern_names, replicate  # noqa: E402
from repro_torch.core.graph import CHECKSUM_MOD  # noqa: E402
from repro_torch.dist import plan_comm  # noqa: E402
from repro_torch.kernels import bodies  # noqa: E402

PATTERN_KW = {"nearest": {"radix": 3}, "spread": {"radix": 3}}
SEEDS = (0, 1, 2)
WAIT, STORE = "wait", "store"


class Deadlock(AssertionError):
    pass


class Words:
    """Signal words: key -> (tag, value); an unwritten word reads (0, 0),
    as the launch's memset leaves it."""

    def __init__(self):
        self.words = {}

    def store(self, key, tag: int, value) -> None:
        assert tag > 0
        assert key not in self.words, f"word {key} written twice"
        self.words[key] = (tag, value)

    def wait(self, key, tag: int):
        """Poll ``key`` until it carries ``tag`` (yielding WAIT at every
        poll that finds it unwritten); returns the value."""
        while True:
            got, value = self.words.get(key, (0, 0))
            if got == tag:
                return value
            assert got == 0, f"word {key} carries tag {got}, not {tag}"
            yield WAIT


def schedule(ctas, rng) -> None:
    """Run the generator CTAs to their ends, picking the next CTA to move at
    random with a weight (its speed) drawn once per CTA.  A CTA yields WAIT
    when a poll finds its word unwritten and STORE after a store; when every
    live CTA has polled in vain since the last store, none can move again."""
    speed = rng.uniform(0.02, 1.0, len(ctas))
    alive, waiting = set(range(len(ctas))), set()
    while alive:
        for k in rng.choice(len(ctas), size=1024, p=speed / speed.sum()):
            if k not in alive:
                continue
            try:
                event = next(ctas[k])
            except StopIteration:
                alive.remove(k)
                waiting.discard(k)
                continue
            if event == WAIT:
                waiting.add(k)
                if waiting >= alive:
                    raise Deadlock(f"CTAs {sorted(waiting)} all wait")
            else:
                waiting.clear()


def final_wave(kernel, its, base, acc, combined, cols, height, P):
    """The last wave from the last timestep's acc and combined checksum,
    with the body run as the plain versions run it."""
    seed = torch.as_tensor(acc, dtype=torch.float32) * bodies.FOLD_BLOCK
    res = bodies.run_kernel_columns(
        kernel, torch.as_tensor(its.reshape(-1, 1)), seed.reshape(-1, 1),
        kernel.iterations, plain=True).reshape(acc.shape)
    return body.make_payload(height - 1, torch.as_tensor(cols),
                             torch.as_tensor(base), torch.as_tensor(combined),
                             res, P).reshape(-1, P)


# ----------------------------------------------------------------- K3
def k3_cta(b, nblocks, tabs, G, H, W, words, last, order="t-outer"):
    """One CTA of fused.cu: tasks b, b + nblocks, ... of each timestep, t
    outermost; a task's lanes wait on the t-1 word of each live dependency,
    then the task stores its own (t, task) word, tag t+1."""
    idx, mask, _, base = tabs
    tasks = range(b, G * W, nblocks)
    steps = ([(t, task) for t in range(H) for task in tasks]
             if order == "t-outer" else
             [(t, task) for task in tasks for t in range(H)])
    for t, task in steps:
        g, i = divmod(task, W)
        row = g * H + t
        acc = 0
        if t > 0:
            for r in range(idx.shape[2]):  # lane r
                if mask[row, i, r]:
                    v = yield from words.wait((row - 1, int(idx[row, i, r])),
                                              t)
                    acc = (acc + v) % CHECKSUM_MOD
        combined = (int(base[row, i, 0]) + acc) % CHECKSUM_MOD
        last[task] = (t, acc, combined)
        words.store((row, i), t + 1, combined)
        yield STORE


def run_k3(graphs, nblocks, seed, order="t-outer"):
    g0 = graphs[0]
    G, H, W = len(graphs), g0.height, g0.width
    tabs = MegakernelBackend._tables(graphs, max(1, g0.max_radix()))
    words, last = Words(), {}
    schedule([k3_cta(b, nblocks, tabs, G, H, W, words, last, order)
              for b in range(nblocks)], np.random.RandomState(seed))
    assert len(words.words) == G * H * W
    assert all(last[k][0] == H - 1 for k in range(G * W))
    acc = np.array([last[k][1] for k in range(G * W)]).reshape(G, W)
    combined = np.array([last[k][2] for k in range(G * W)]).reshape(G, W)
    its = tabs[2].reshape(G, H, W)[:, H - 1]
    base = tabs[3].reshape(G, H, W)[:, H - 1]
    got = final_wave(g0.kernel, its, base, acc, combined, np.arange(W), H,
                     g0.payload_elems)
    kw = dict(kernel=g0.kernel, ngraphs=G, height=H,
              payload_elems=g0.payload_elems)
    want = taskbench_fused_plain(*tables_from_numpy(tabs, "cpu"), **kw)
    assert torch.equal(got, want)


def graph(pattern, width=8, height=8):
    return make_graph(width=width, height=height, pattern=pattern,
                      kernel="compute", iterations=3, imbalance=0.5,
                      **PATTERN_KW.get(pattern, {}))


@pytest.mark.parametrize("pattern", pattern_names())
def test_k3_protocol_matches_plain(pattern):
    g = graph(pattern)
    for graphs in ([g], replicate(g, 3)):
        tasks = len(graphs) * g.width
        for nblocks in (tasks, 5, 1):  # a CTA a task, then grid-stride
            for seed in SEEDS:
                run_k3(graphs, nblocks, seed)


def test_k3_protocol_needs_t_outermost():
    """The scheduler's deadlock check works: one CTA that runs a task's
    timesteps before the next task waits at t = 1 on a neighbour it has not
    run, which the t-outer order of fused.cu never does."""
    run_k3([graph("stencil")], 1, 0)
    with pytest.raises(Deadlock):
        run_k3([graph("stencil")], 1, 0, order="task-outer")


# ----------------------------------------------------------------- K4
def k4_cta(me, tabs, offsets, H, P, words, last, rng):
    """One CTA (rank) of onesided.cu: wait on every word of the t-1 inbox
    slot (its threads poll in no fixed order), run the local tasks over
    [inbox | own t-1 wave], then put the send rows of every active offset,
    one word an element, tag t+1."""
    idx, mask, _, base, send_rows = tabs[:5]
    ranks, _, local, R = idx.shape
    n_off, cap = len(offsets), send_rows.shape[2]
    nin = n_off * cap
    own_prev = np.zeros((local, P))
    for t in range(H):
        inbox = {}
        if t > 0:
            for e in rng.permutation(nin * P):
                v = yield from words.wait((me, t - 1, int(e)), t)
                if e % P == 3:
                    inbox[e // P] = int(v)
        cur = np.zeros((local, P))
        accs, combs = [], []
        for i in range(local):
            acc = 0
            if t > 0:
                for r in range(R):
                    if mask[me, t, i, r]:
                        k = int(idx[me, t, i, r])
                        v = inbox[k] if k < nin else int(own_prev[k - nin, 3])
                        acc = (acc + v) % CHECKSUM_MOD
            combined = (int(base[me, t, i, 0]) + acc) % CHECKSUM_MOD
            # the payload row; slots 4.. (the body's result) are never read
            cur[i, :4] = (t, me * local + i, base[me, t, i, 0], combined)
            accs.append(acc)
            combs.append(combined)
        if t < H - 1:
            for e in range(nin * P):
                slot, s = divmod(e, P)
                dst = (me + offsets[slot // cap]) % ranks
                row = send_rows[me, slot // cap, slot % cap]
                words.store((dst, t, e), t + 1, cur[row, s])
                yield STORE
        own_prev = cur
        last[me] = (t, accs, combs)


@pytest.mark.parametrize("pattern", pattern_names())
def test_k4_protocol_matches_plain(pattern):
    for width, ranks in ((8, 2), (10, 4), (12, 8)):
        g = graph(pattern, width=width)
        H, P = g.height, g.payload_elems
        offsets, tabs = MegakernelBackend._onesided_tables(
            g, plan_comm(g, ranks, "cols", comm="onesided"))
        local = tabs[0].shape[2]
        nin = len(offsets) * tabs[4].shape[2]
        want = taskbench_onesided_plain(
            *onesided_tables_from_numpy(offsets, tabs, "cpu"),
            kernel=g.kernel, height=H, payload_elems=P)
        for seed in SEEDS:
            rng = np.random.RandomState(seed)
            words, last = Words(), {}
            schedule([k4_cta(me, tabs, offsets, H, P, words, last, rng)
                      for me in range(ranks)], rng)
            assert len(words.words) == ranks * (H - 1) * nin * P
            assert all(last[me][0] == H - 1 for me in range(ranks))
            acc = np.array([last[me][1] for me in range(ranks)])
            combined = np.array([last[me][2] for me in range(ranks)])
            cols = np.arange(ranks * local).reshape(ranks, local)
            got = final_wave(g.kernel, tabs[2][:, H - 1],
                             tabs[3][:, H - 1, :, 0], acc, combined, cols, H,
                             P)
            assert torch.equal(got, want), (width, ranks, seed)

"""Kernel G's host side on the CPU: the key nodes it draws from, its
generator written as the CUDA source writes it, its bounds and the attempt
pass's dispatch.

The kernel (``fries_tpu_torch/csrc/attempt.cu``) draws element k of each
node's uniforms for attempt slot k; its card tests are in
``tests/test_torch_kernels_cuda.py``.  Here: the nodes' keys are those of
the plain pass's ``KeyTree.fold`` / ``split``, a NumPy copy of the kernel's
splitmix64 gives ``KeyTree.uniform``'s bits, and CPU tensors and the
near-uniform distribution take the plain pass.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu_torch import profiling, rng, rung, synth  # noqa: E402
from fries_tpu_torch.drivers import fciqmc  # noqa: E402
from fries_tpu_torch.runtime import attempt  # noqa: E402

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
MUL1 = np.uint64(0xBF58476D1CE4E5B9)
MUL2 = np.uint64(0x94D049BB133111EB)
SEEDS = [0, 2**31 + 5, 3037000493]
SYMM8 = np.array([0, 1, 0, 1, 0, 1, 2, 3])


def kernel_uniform(key: int, k):
    """``uniform`` of csrc/attempt.cu on uint64 NumPy arrays: splitmix64 of
    k * GOLDEN + key, its top 53 bits times 2^-53."""
    with np.errstate(over="ignore"):
        z = np.asarray(k, dtype=np.uint64) * GOLDEN + np.uint64(key)
        z = (z ^ (z >> np.uint64(30))) * MUL1
        z = (z ^ (z >> np.uint64(27))) * MUL2
    z ^= z >> np.uint64(31)
    return (z >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


def step_nodes(seed, iterat):
    """(k_split, kd, ks) of a step, as ``fciqmc.build``'s ``merge_input``
    derives them."""
    k_split, k_spawn, _, _ = rng.KeyTree(seed).fold(iterat).split(4)
    kd, ks = k_spawn.split(2)
    return k_split, kd, ks


def mixed_split(key: int, n: int):
    """``KeyTree.split``'s child keys written out with ``rng.mix64``."""
    base = rng.mix64(key ^ 0x5EED5EED5EED5EED)
    return [rng.mix64(base + (j + 1) * 0x9E3779B97F4A7C15) for j in range(n)]


@pytest.mark.parametrize("iterat", [0, 59, 1 << 20])
@pytest.mark.parametrize("seed", SEEDS)
def test_node_keys_are_the_step_nodes(seed, iterat):
    """The kernel's seven keys are k_split's, kd's four children's and ks's
    two children's, in that order, as ``split`` and ``fold`` derive them."""
    k_split, kd, ks = step_nodes(seed, iterat)
    keys = attempt.node_keys(k_split, kd, ks)
    assert keys == [k_split.key, *mixed_split(kd.key, 4), *mixed_split(ks.key, 2)]
    assert keys[1:5] == [c.key for c in kd.split(4)]
    assert keys[5:] == [c.key for c in ks.split(2)]
    assert all(0 <= k < 1 << 64 for k in keys) and len(set(keys)) == 7


def test_node_keys_need_key_trees():
    """Nodes of another tree (a test's fixed uniforms, the reference's keys)
    raise: kernel G draws only from key trees."""
    k_split, kd, ks = step_nodes(1, 0)
    with pytest.raises(TypeError, match="KeyTree"):
        attempt.node_keys(object(), kd, ks)
    with pytest.raises(TypeError, match="KeyTree"):
        attempt.node_keys(k_split, kd, object())


def tree_uniform_at(key: int, k: int) -> float:
    """Element k of ``KeyTree.uniform`` of the node with key ``key``, from
    its definition with ``rng.mix64`` (for slots past a small draw)."""
    z = rng.mix64((k * 0x9E3779B97F4A7C15 + key) & ((1 << 64) - 1))
    return (z >> 11) * 2.0 ** -53


@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_generator_gives_key_tree_bits(seed):
    """The kernel's splitmix64 reproduces ``KeyTree.uniform``'s bits for
    every node it draws from, at the first 4096 slots, around 2^24 and at
    the last of 2^27."""
    nodes = step_nodes(seed, 7)
    trees = [nodes[0], *nodes[1].split(4), *nodes[2].split(2)]
    for tree, key in zip(trees, attempt.node_keys(*nodes)):
        k = np.arange(4096)
        want = tree.uniform((4096,)).numpy()
        assert np.array_equal(kernel_uniform(key, k).view(np.uint64), want.view(np.uint64))
        assert [tree_uniform_at(key, int(i)) for i in k[:64]] == want[:64].tolist()
        far = np.r_[(1 << 24) - 3 + np.arange(6), (1 << 27) - 1]
        assert kernel_uniform(key, far).tolist() == [tree_uniform_at(key, int(i)) for i in far]


@pytest.mark.parametrize("n_orb,n_elec,n_words,max_count,want", [
    (26, 10, 2, 6, True),           # the walker cell's N2
    (8, 4, 1, 2, True),
    (64, 32, 4, 64, True),
    (65, 10, 5, 9, False),          # past MAX_ORB
    (36, 34, 3, 5, False),          # past MAX_ELEC
    (26, 10, 1, 6, False),          # the key's words do not hold 52 bits
    (4, 10, 1, 1, False),           # no empty orbital of a spin
])
def test_fits(n_orb, n_elec, n_words, max_count, want):
    assert attempt.fits(n_orb, n_elec, n_words, max_count) is want


@pytest.mark.parametrize("dist", ["HB", "NU"])
def test_cpu_and_nu_take_the_plain_pass(monkeypatch, dist):
    """On the CPU (and for NU anywhere) the spawner has no kernel tables:
    each step runs ``_attempt_pass_plain`` once, never kernel G, and counts
    no plain pass on the card."""
    cfg = fciqmc.FciqmcConfig(eps=0.02, target_walkers=600.0, capacity=256, attempt_cap=1024,
                              init_thresh=2.0, distribution=dist)
    ham = synth.make_system(8, 4, symm=SYMM8, seed=3)
    assert fciqmc.spawn_tables(ham, cfg, 0.5).kernel is None
    calls = []
    plain = fciqmc._attempt_pass_plain
    monkeypatch.setattr(fciqmc, "_attempt_pass_plain",
                        lambda *a: calls.append(1) or plain(*a))

    def refuse(*a, **k):
        raise AssertionError("kernel G launched for CPU tensors")

    monkeypatch.setattr(attempt, "launch", refuse)
    step, _, state, aux = fciqmc.build(ham, cfg, seed=4, init_walkers=300)
    before = profiling.total("attempt.plain_on_card")
    for _ in range(3):
        state, m = step(state, *rung.estimator_args(aux))
    assert len(calls) == 3
    assert profiling.total("attempt.plain_on_card") == before
    assert int(m["nnonz"]) > 1

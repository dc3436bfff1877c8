"""The order in which pytest-xdist's ``--dist load`` hands out the tests.

xdist 3.8's ``LoadScheduling.schedule()`` first sends each of its W
workers one block of ``max(2, (N // W) // 4)`` consecutive items of the N
collected, then refills a worker from the front of the pending items when
its queue runs low. In collected order the heaviest tests sit side by
side (``tests/test_coef_shard.py`` is collected first), so one worker got
them all and set the suite's wall while the others went idle.
``spread_heavy`` reorders the collection so that each first block opens
with at most one heavy test and the rest of the heavy tests lie apart.

This module imports neither JAX nor pytest, so its rule is unit-tested on
synthetic node ids (``tests/test_schedule.py``).
"""

# The tests whose own call took 60 s or more of one worker in a whole
# tier-1 run (``-n 6 --dist load``, 8-core CPU host, cold XLA cache),
# heaviest first, with those seconds. A test that grows past 60 s joins
# this list. A test whose cost is the set-up of a fixture its neighbours
# share (``test_engine.py::test_square``'s ``shared_eng``) stays off it:
# moved away, it would build that fixture on one more worker.
HEAVY = (
    "tests/test_coef_shard.py::test_coef_sharded_batched_fused_chains",  # 421
    "tests/test_coef_shard.py::"
    "test_coef_sharded_pallas_local_bit_exact",  # 335
    "tests/test_fused_switch.py::"
    "test_engine_chained_mult_and_rotate_with_fused_switch",  # 298
    "tests/test_coef_shard.py::"
    "test_coef_sharded_2d_mesh_pallas_bit_exact",  # 239
    "tests/test_coef_shard.py::test_coef_sharded_2d_mesh_bit_exact",  # 216
    "tests/test_mxu_pallas.py::test_engine_batched_mult_native_path",  # 177
    "tests/test_coef_shard.py::test_intt_coef_sharded_bit_exact[10-4]",  # 173
    "tests/test_shoup_chains.py::test_mult_chain_mod_q_equal",  # 157
    "tests/test_fused_switch.py::test_engine_mult_with_fused_switch",  # 152
    "tests/test_shoup_chains.py::"
    "test_mult_chain_mod_q_equal_pallas_interpret",  # 149
    "tests/test_mxu.py::test_engine_mxu_backend_end_to_end",  # 121
    "tests/test_coef_shard.py::test_ntt_coef_sharded_bit_exact[10-4]",  # 120
    "tests/test_pallas_paths.py::test_generic_4d_row_branch_logN11",  # 94
    "tests/test_mxu.py::test_engine_mxu_kernels_on_mesh_interpret",  # 94
    "tests/test_pallas_paths.py::test_big_m_with_split",  # 93
    "tests/test_sharded.py::test_sharded_pallas_kernels",  # 92
    "tests/test_pallas_paths.py::test_channel_slab_path",  # 84
    "tests/test_sharded.py::test_sharded_mult_relin_rescale[params2-4]",  # 72
    "tests/test_mxu_pallas.py::test_engine_fused_mxu_switch_matches_xla",  # 68
    "tests/test_moddown.py::test_engine_end_to_end_with_tiled_moddown",  # 60
)


def first_block(n, workers):
    """Items in each worker's first block (xdist 3.8 ``LoadScheduling``)."""
    return max(2, (n // workers) // 4)


def spread_heavy(nodeids, heavy, workers):
    """Return the indices of ``nodeids`` in the order to hand them out.

    The first ``workers`` tests of ``heavy`` that were collected (``heavy``
    is ordered heaviest first) open the workers' first blocks, at indices
    k * block. The other heavy tests are spaced evenly through the rest of
    the order. Every other test keeps its collected order. Without a
    worker count, or with too few tests to keep the heavy ones apart, the
    order is unchanged.
    """
    n = len(nodeids)
    if not workers:
        return list(range(n))
    where = {nid: i for i, nid in enumerate(nodeids)}
    hv = [where[h] for h in heavy if h in where]
    block = first_block(n, workers)
    start, tail = block * workers, len(hv[workers:])
    if n < start + tail:
        return list(range(n))
    step = (n - start) / max(1, tail)
    slots = [k * block for k in range(len(hv) - tail)]
    slots += [start + int((j + 0.5) * step) for j in range(tail)]
    order = [None] * n
    for slot, i in zip(slots, hv):
        order[slot] = i
    taken = set(hv)
    light = iter(i for i in range(n) if i not in taken)
    return [next(light) if i is None else i for i in order]

"""RNS partitioning plan.

Re-derivation of the reference's sharding/partition plan
(reference: src/liberate/ntt/rns_partition.py:4-170). Two distinct roles:

1. **Gadget decomposition structure** for hybrid key switching: the ordinary
   (scale) primes are split into partitions of size alpha = num_special_primes,
   plus a single-prime partition for the base prime, plus the special-prime
   partition. Each partition is one gadget digit; the key-switching key has
   one component per digit.

2. **Device placement**: the reference deals partitions to GPUs
   round-robin. The port runs on one device (num_devices=1), but the plan
   object still describes which partition would live on which shard.

Channel-layout convention of this framework: the logical array at level
``l`` holds the contiguous prime suffix q[l:]; keys hold all level-0
channels and are sliced by ``l``.
"""

import numpy as np


class RnsPartition:
    def __init__(self, num_ordinary_primes=17, num_special_primes=2,
                 num_devices=1):
        self.num_ordinary_primes = num_ordinary_primes
        self.num_special_primes = num_special_primes
        self.num_devices = num_devices
        self.num_scales = num_ordinary_primes - 1
        self.base_prime_idx = num_ordinary_primes - 1

        alpha = num_special_primes
        nscale = num_ordinary_primes - 1
        num_partitions = -(-nscale // alpha)
        self.num_partitions = num_partitions

        # Partitions over global prime indices: alpha-sized scale blocks,
        # then the base prime, then the special primes.
        scale_idx = list(range(nscale))
        partitions = [scale_idx[i * alpha:(i + 1) * alpha]
                      for i in range(num_partitions)]
        partitions.append([nscale])  # base prime partition
        partitions.append(list(range(num_ordinary_primes,
                                     num_ordinary_primes + alpha)))
        self.partitions = partitions

        # Round-robin deal of scale partitions to devices, dealt from the
        # TOP partition down (device i takes partitions top-i, top-i-D,
        # ... — same placement as the reference's allocation); device 0
        # additionally owns the base partition; every device holds the
        # special partition.
        def deal(dev):
            owned = range(num_partitions - 1 - dev, -1, -num_devices)
            return sorted(owned)

        part_allocations = [deal(i) for i in range(num_devices)]
        part_allocations[0].append(num_partitions)
        for p in part_allocations:
            p.append(num_partitions + 1)
        self.part_allocations = part_allocations

        self.prime_allocations = [
            [partitions[pi] for pi in alloc] for alloc in part_allocations
        ]
        self.flat_prime_allocations = [
            sum(alloc, []) for alloc in self.prime_allocations
        ]

        self._compute_destination_arrays()
        self._compute_rescaler_locations()
        self._compute_partitions()

    # -- per-level channel residency ------------------------------------------

    def _compute_destination_arrays(self):
        filter_alloc = lambda devi, lvl: [
            a for a in self.flat_prime_allocations[devi] if a >= lvl
        ]
        self.destination_arrays_with_special = [
            [filter_alloc(d, lvl) for d in range(self.num_devices)]
            for lvl in range(self.num_ordinary_primes)
        ]
        strip = lambda arrs: [a[:-self.num_special_primes] for a in arrs]
        self.destination_arrays = [
            [a for a in strip(arrs) if len(a) > 0]
            for arrs in self.destination_arrays_with_special
        ]

    def _compute_rescaler_locations(self):
        mins = lambda arrs: [min(a) for a in arrs]
        self.rescaler_loc = [
            mins(a).index(min(mins(a)))
            for a in self.destination_arrays_with_special
        ]

    # -- per-level partition views ---------------------------------------------

    def partings(self, lvl):
        count = lambda arr: np.array([len(a) for a in arr])
        part_counts = [count(a) for a in self.prime_allocations]
        part_cumsums = [np.cumsum(a) for a in part_counts]
        level_diffs = [
            len(a) - len(b)
            for a, b in zip(self.destination_arrays_with_special[0],
                            self.destination_arrays_with_special[lvl])
        ]
        part_cumsums_lvl = [
            [c for c in (cs - d) if c > 0]
            for cs, d in zip(part_cumsums, level_diffs)
        ]
        part_count_lvl = [np.diff(a, prepend=0) for a in part_cumsums_lvl]
        parts_lvl = [
            [list(range(s, e)) for s, e in zip([0] + list(cs[:-1]), cs)]
            for cs in part_cumsums_lvl
        ]
        return part_cumsums_lvl, part_count_lvl, parts_lvl

    def _compute_partitions(self):
        self.part_cumsums, self.part_counts, self.parts = [], [], []
        self.destination_parts, self.destination_parts_with_special = [], []
        self.p, self.p_special, self.diff = [], [], []

        self.d = [self.destination_arrays[0][d] for d in range(self.num_devices)]
        self.d_special = [
            self.destination_arrays_with_special[0][d]
            for d in range(self.num_devices)
        ]

        for lvl in range(self.num_ordinary_primes):
            pcu, pco, par = self.partings(lvl)
            self.part_cumsums.append(pcu)
            self.part_counts.append(pco)
            self.parts.append(par)

            dest = self.destination_arrays_with_special[lvl]
            destp_special = [
                [[d[pi] for pi in p] for p in dev_p]
                for d, dev_p in zip(dest, par)
            ]
            self.destination_parts_with_special.append(destp_special)
            self.destination_parts.append([dp[:-1] for dp in destp_special])

            diff = [
                len(d1) - len(d2)
                for d1, d2 in zip(self.destination_arrays_with_special[0],
                                  self.destination_arrays_with_special[lvl])
            ]
            p_special = [
                [[pi + d for pi in p] for p in dev_p]
                for d, dev_p in zip(diff, par)
            ]
            self.p_special.append(p_special)
            self.p.append([dp[:-1] for dp in p_special])
            self.diff.append(diff)


# Reference-compatible alias.
rns_partition = RnsPartition

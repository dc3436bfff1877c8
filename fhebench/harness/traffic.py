"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and drives the engine's public API with them.

A mix names a pool of fresh level-0 ciphertexts (``pool``) of seeded slot
values (uniform reals in ``slots``), encrypted at set-up, and the steps of
one request over it (``request``):

- ``{"op": "mult_batched", "pairs": B}``: ``mult_batched`` of B pairs
  drawn from the pool; B answers;
- ``{"op": "mult"}``: ``mult`` of one pair drawn from the pool; one answer;
- ``{"op": "rotate_add", "delta": d}``: each answer becomes
  ``add(rotate_single(x, key_d), x)``; the rotation keys are made at
  set-up.

One client runs the requests in a closed loop: the next is sent once the
previous one's answers are on the card (``torch.cuda.synchronize``).
Every request has the same shape; the seed draws only the slot values
and which pool entries each request takes.
"""

import json

import numpy as np

MULT_OPS = ("mult_batched", "mult")


class Traffic:
    def __init__(self, path):
        with open(path) as f:
            spec = json.load(f)
        self.name = spec["name"]
        self.pool = int(spec["pool"])
        self.slots = tuple(spec["slots"])
        self.steps = spec["request"]
        self.sample_requests = int(spec["sample_requests"])
        self.trace_requests = int(spec["trace_requests"])
        self.warmup_requests = int(spec["warmup_requests"])
        if not self.steps or self.steps[0]["op"] not in MULT_OPS:
            raise ValueError(f"{path}: a request starts with a multiply")
        for step in self.steps[1:]:
            if step["op"] != "rotate_add":
                raise ValueError(f"{path}: unknown step {step['op']!r}")
        first = self.steps[0]
        self.pairs = int(first.get("pairs", 1))
        self.batched = first["op"] == "mult_batched"
        self.deltas = [int(s["delta"]) for s in self.steps[1:]]

    @property
    def answers_per_request(self):
        return self.pairs

    @property
    def mults_per_answer(self):
        return 1

    def messages(self, seed, num_slots):
        """The pool's slot values [pool, num_slots] (float64)."""
        rng = np.random.default_rng([seed % 2 ** 64, 0])
        return rng.uniform(self.slots[0], self.slots[1],
                           (self.pool, num_slots))

    def plan(self, seed):
        """The pool indices of each request in order: (a [B], b [B])."""
        rng = np.random.default_rng([seed % 2 ** 64, 1])
        while True:
            idx = rng.integers(0, self.pool, 2 * self.pairs)
            yield idx[:self.pairs], idx[self.pairs:]

    def make_keys(self, engine, sk):
        return {d: engine.create_rotation_key(sk, d) for d in self.deltas}

    def issue(self, engine, evk, keys, pool, idx):
        """Send one request; its answers (ciphertexts)."""
        a, b = idx
        if self.batched:
            out = engine.mult_batched([pool[i] for i in a],
                                      [pool[i] for i in b], evk)
        else:
            out = [engine.mult(pool[a[0]], pool[b[0]], evk)]
        for d in self.deltas:
            out = [engine.add(engine.rotate_single(x, keys[d]), x)
                   for x in out]
        return out

    def expected(self, msgs, idx):
        """The plain slots each answer of a request has to decrypt to."""
        a, b = idx
        out = [msgs[i] * msgs[j] for i, j in zip(a, b)]
        for d in self.deltas:
            out = [z + np.roll(z, d) for z in out]
        return out

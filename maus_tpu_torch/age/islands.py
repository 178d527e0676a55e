"""Island-model AGE: independent genesis engines, one batched stage-III
evaluation, ring migration.

Counterpart of ``maus_tpu/age/islands.py``. M islands each run the
reference's cycle (stages I, II and IV on the host, a random stream and a
novelty archive per island); every cycle, all islands' candidates compile
to one stacked tape batch that one diffusion simulation evaluates on the
device; every ``migrate_every`` cycles the top-k archived genomes of each
island join the next island's weave pool (a ring). With a ``mesh`` whose
replica axis has r > 1 ranks (every rank running the same ``IslandAGE``),
the batch is padded to a multiple of r and each replica rank simulates its
contiguous part; the fitness comes back to every rank by a scatter into
the full batch and one all_reduce over the replica axis, which adds zeros
and so returns each rank's values unchanged. The trajectory does not
depend on where the batch runs.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..parallel import comm
from ..parallel.mesh import REPLICA_AXIS
from . import diffusion
from .engine import AgeConfig, GenesisEngine, Genome
from .tape import compile_tree, stack_tapes


class IslandAGE:
    """M islands × the reference's genesis cycle, with a shared batched
    stage-III evaluation on ``device`` (default: the card; the mesh's
    device with ``mesh``), split over the mesh's replica ranks when there
    are several, and ring migration."""

    def __init__(self, n_islands: int = 4, config: Optional[AgeConfig] = None,
                 seed: int = 0, migrate_every: int = 5,
                 migrate_top_k: int = 2, verbose: bool = False, device=None,
                 mesh=None):
        if n_islands < 1:
            raise ValueError("need at least one island")
        if mesh is not None and device is None:
            device = mesh.device
        self.mesh = mesh
        self.conf = config or AgeConfig()
        self.engines = [GenesisEngine(self.conf, seed=seed + 1009 * i,
                                      verbose=False, device=device)
                        for i in range(n_islands)]
        self.migrate_every = migrate_every
        self.migrate_top_k = migrate_top_k
        self.verbose = verbose
        self.cycle = 0
        self._pending: List[List[Genome]] = [[] for _ in range(n_islands)]

    # -- batched stage-III evaluation ----------------------------------------
    def _eval_fitness(self, genomes: List[Genome]) -> np.ndarray:
        c = self.conf
        if not genomes:
            return np.zeros((0,), np.float32)
        tapes = stack_tapes([compile_tree(g.tree, c.variables)
                             for g in genomes])
        kernel = self.engines[0]._base_kernel
        r = 1 if self.mesh is None else self.mesh.size(REPLICA_AXIS)
        if r == 1:
            return diffusion.population_fitness(
                tapes, c.diffusion_n, c.diffusion_t, kernel).cpu().numpy()
        P = len(genomes)
        pad = (-P) % r
        if pad:
            tapes = {k: np.concatenate([v, v[:1].repeat(pad, axis=0)])
                     for k, v in tapes.items()}
        per = (P + pad) // r
        lo = self.mesh.index(REPLICA_AXIS) * per
        mine = diffusion.population_fitness(
            {k: v[lo:lo + per] for k, v in tapes.items()}, c.diffusion_n,
            c.diffusion_t, kernel)
        return comm.gather(mine, lo, P + pad, self.mesh, dim=0,
                           axis=REPLICA_AXIS)[:P].cpu().numpy()

    # -- migration (ring) ----------------------------------------------------
    def _migrate(self):
        k = self.migrate_top_k
        n = len(self.engines)
        for i, e in enumerate(self.engines):
            ranked = sorted(e.harmonic_library,
                            key=lambda g: g.stability + g.integrity + g.novelty,
                            reverse=True)[:k]
            dest = (i + 1) % n
            # fresh Genome wrappers: island-local scores are re-derived on the
            # destination island (its own stage III re-evaluates them)
            self._pending[dest].extend(
                Genome(tree=g.tree,
                       rules_version=self.engines[dest].rules_version)
                for g in ranked)

    # -- one synchronized cycle across all islands --------------------------
    def run_cycle(self) -> dict:
        self.cycle += 1
        per_island: List[List[Genome]] = []
        for i, e in enumerate(self.engines):
            e.cycle_count += 1
            e.stage_I_ingest_primitives()
            cands = e.stage_II_weave()
            if self._pending[i]:
                for g in self._pending[i]:
                    g.novelty = e.rng.uniform(0.2, 0.8)
                cands = self._pending[i] + cands
                self._pending[i] = []
            per_island.append(cands)

        flat = [g for isl in per_island for g in isl]
        fitness = self._eval_fitness(flat)

        summaries = []
        ofs = 0
        for e, cands in zip(self.engines, per_island):
            fit = fitness[ofs:ofs + len(cands)]
            ofs += len(cands)
            summaries.append(e.complete_cycle(cands, fitness=fit))

        if self.migrate_every and self.cycle % self.migrate_every == 0:
            self._migrate()

        best = max((s["best_fitness"] for s in summaries), default=0.0)
        out = {
            "cycle": self.cycle,
            "islands": summaries,
            "best_fitness": best,
            "library_total": sum(len(e.harmonic_library)
                                 for e in self.engines),
        }
        if self.verbose:
            print(f"ISLANDS cycle {self.cycle}: best={best:.3f} "
                  f"lib_total={out['library_total']}")
        return out

    def run(self, cycles: Optional[int] = None) -> List[dict]:
        return [self.run_cycle()
                for _ in range(cycles or self.conf.max_cycles)]

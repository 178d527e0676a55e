"""Algorithmic Genesis Engine: the generate/score/archive orchestrator
(reference ``AlgorithmicGenesisEngine``, K:326-509).

Counterpart of ``maus_tpu/age/engine.py``, with the same Ω factors (K, Λ,
Δ, Γ, M, E) and logistic growth, the same 4-stage cycle (substrate review →
weave → test → synthesize) and the same harmonic library with
canonical-form novelty dedup. Stages I, II and IV run on the host from the
engine's ``random.Random(seed)``; stage III compiles the candidate batch to
tapes and runs one batched diffusion simulation on the engine's device (the
card unless ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import random as _random
from typing import List, Optional

import numpy as np
import torch

from ..solver.api import _resolve_device
from . import diffusion, tape as tape_mod
from .tape import Node, compile_tree, generate_tree, stack_tapes


@dataclasses.dataclass
class AgeConfig:
    """Reference ``AGE_Config`` (K:283-314), same defaults."""

    max_cycles: int = 30
    candidates_per_cycle: int = 20
    stability_threshold: float = 0.05
    integrity_threshold: float = 0.02
    emergence_threshold: float = 0.7
    variables: tuple = tape_mod.VARIABLES
    const_range: tuple = (-2.5, 2.5)
    unary_ops: tuple = ("neg", "abs", "sin", "cos", "tanh", "sig", "sqrt", "exp")
    binary_ops: tuple = ("+", "-", "*", "/")
    max_tree_depth: int = 4
    max_expected_complexity: float = 15.0
    diffusion_n: int = 50
    diffusion_t: int = 50
    base_kernel: tuple = (0.25, 0.5, 0.25)
    rate_k: float = 0.02
    rate_l: float = 0.06
    rate_d: float = 0.05
    rate_g: float = 0.04
    rate_m: float = 0.04
    emergence_boost: float = 0.35
    emergence_integral_eps: float = 0.2


@dataclasses.dataclass
class Genome:
    """Reference ``ComposedStructure`` (K:252-279)."""

    tree: Node
    rules_version: float = 0.1
    complexity: float = 0.0
    stability: float = 0.0        # = diffusion fitness (K:433)
    integrity: float = 0.0
    novelty: float = 0.0
    is_emergent: bool = False
    details: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.complexity = float(self.tree.complexity())

    def canonical_form(self) -> Optional[str]:
        return self.tree.canonical_form()


def normalize_score(v, lo=0.0, hi=1.0):
    return max(lo, min(hi, float(v)))


def logistic_growth(current, max_val, rate, strength=1.0):
    """Saturating update (K:319-323)."""
    cv = normalize_score(current, 0, max_val)
    if abs(max_val) < 1e-9 or cv >= max_val:
        return cv
    s = normalize_score(strength, 0, 1)
    return normalize_score(cv + rate * s * (max_val - cv), 0, max_val)


class GenesisEngine:
    """``device``: where stage III runs (default: the card; ``"cpu"`` runs
    it on the CPU)."""

    def __init__(self, config: Optional[AgeConfig] = None, seed: int = 0,
                 verbose: bool = False, device=None):
        self.conf = config or AgeConfig()
        self.device = _resolve_device(None, device)
        self.rng = _random.Random(seed)
        self.verbose = verbose
        c = self.conf
        substrate_richness = (len(c.variables) + 1 + len(c.unary_ops)
                              + len(c.binary_ops))
        total_ops = len(tape_mod.UNARY_OPS) + len(tape_mod.BINARY_OPS)
        self.K = normalize_score(
            substrate_richness / (len(c.variables) + 1 + total_ops))
        self.L = 0.15
        self.D = 0.1
        self.G = 0.15
        self.M = 0.05
        self.E = 0.0
        self.omega_integral = 0.0
        self.cycle_count = 0
        self.harmonic_library: List[Genome] = []
        self.novelty_tracker: set = set()
        self.rules_version = 0.1
        self._base_kernel = torch.tensor(c.base_kernel, dtype=torch.float32,
                                         device=self.device)

    # -- stage I (K:342-344) -------------------------------------------------
    def stage_I_ingest_primitives(self):
        self.K = logistic_growth(self.K, 1.0, self.conf.rate_k, 0.01)

    # -- stage II (K:384-403) ------------------------------------------------
    def stage_II_weave(self) -> List[Genome]:
        c = self.conf
        out = []
        for _ in range(c.candidates_per_cycle):
            depth = self.rng.randint(1, c.max_tree_depth)
            tree = generate_tree(self.rng, 0, depth, c.variables, c.unary_ops,
                                 c.binary_ops, c.const_range)
            g = Genome(tree=tree, rules_version=self.rules_version)
            g.novelty = self.rng.uniform(0.2, 0.8)    # K:263
            out.append(g)
        if out:
            avg_nov = float(np.mean([g.novelty for g in out]))
            avg_cplx = float(np.mean([g.complexity for g in out]))
            norm_cplx = normalize_score(avg_cplx / c.max_expected_complexity)
            strength = (len(out) / c.candidates_per_cycle) * \
                (avg_nov * 0.35 + norm_cplx * 0.35 + 0.3)
        else:
            strength = 0.0
        self.L = logistic_growth(self.L, 1.0, c.rate_l, strength)
        return out

    # -- stage III (K:405-461), batched on the device -------------------------
    def stage_III_test(self, candidates: List[Genome],
                       fitness=None) -> List[Genome]:
        """``fitness``: optional precomputed per-candidate diffusion fitness;
        the island model (age/islands.py) evaluates all islands' candidates
        in one device batch and feeds each island its slice."""
        c = self.conf
        if not candidates:
            self.D = logistic_growth(self.D, 1.0, c.rate_d, 0.0)
            self.G = logistic_growth(self.G, 1.0, c.rate_g, 0.0)
            return []

        if fitness is None:
            tapes = stack_tapes([compile_tree(g.tree, c.variables)
                                 for g in candidates])
            fitness = diffusion.population_fitness(
                tapes, c.diffusion_n, c.diffusion_t,
                self._base_kernel).cpu().numpy()
        else:
            fitness = np.asarray(fitness)

        survivors = []
        found_emergent = False
        for g, fit in zip(candidates, fitness):
            fit = float(fit)
            g.stability = normalize_score(fit)
            g.details["diffusion_fitness"] = fit
            g.details["simulation_successful_ratio"] = 1.0 if fit > 1e-6 else 0.0
            inv_cplx = normalize_score(
                1.0 - g.complexity / c.max_expected_complexity)
            g.integrity = normalize_score(g.stability * inv_cplx)
            form = g.canonical_form()
            g.details["canonical_form"] = form
            if form:
                g.novelty = (0.5 + g.novelty * 0.5) \
                    if form not in self.novelty_tracker else g.novelty * 0.1
            if fit > c.emergence_threshold:
                g.is_emergent = True
                found_emergent = True
            if g.stability >= c.stability_threshold and \
                    g.integrity >= c.integrity_threshold:
                survivors.append(g)

        self.D = logistic_growth(self.D, 1.0, c.rate_d, float(fitness.mean()))
        self.G = logistic_growth(
            self.G, 1.0, c.rate_g,
            float(np.mean([g.integrity for g in candidates])))
        if found_emergent:
            self.E = logistic_growth(self.E, 1.0, 1.0, c.emergence_boost * 1.2)
        return survivors

    # -- stage IV (K:463-498) ------------------------------------------------
    def stage_IV_synthesize(self, survivors: List[Genome]):
        c = self.conf
        self.E *= 0.8
        archived = 0
        rules_evidence = 0
        survivors.sort(key=lambda g: g.stability + g.integrity + g.novelty,
                       reverse=True)
        for g in survivors:
            key = g.canonical_form()
            if key is None:
                continue
            if key not in self.novelty_tracker:
                self.harmonic_library.append(g)
                self.novelty_tracker.add(key)
                archived += 1
                if g.is_emergent:
                    self.E = logistic_growth(self.E, 1.0, 1.0, c.emergence_boost)
            if abs(g.rules_version - self.rules_version) < 1e-3:
                rules_evidence += 1

        strength = rules_evidence / len(survivors) if survivors else 0.0
        if strength > 0.6 and self.rng.random() < 0.35:
            self.rules_version = round(self.rules_version + 0.01, 3)
        self.M = logistic_growth(self.M, 1.0, c.rate_m, strength)

        omega = (self.K * self.L * self.D * self.G * self.M *
                 (1 + c.emergence_integral_eps * self.E))
        self.omega_integral += omega
        return archived

    def run_genesis_cycle(self) -> dict:
        """One full cycle; returns a summary dict (the reference prints)."""
        self.cycle_count += 1
        self.stage_I_ingest_primitives()
        candidates = self.stage_II_weave()
        return self.complete_cycle(candidates)

    def complete_cycle(self, candidates: List[Genome],
                       fitness=None) -> dict:
        """Stages III–IV + summary for already-woven candidates (used by the
        island model, which evaluates fitness for all islands at once)."""
        survivors = self.stage_III_test(candidates, fitness=fitness)
        archived = self.stage_IV_synthesize(survivors)
        best = max((g.stability for g in candidates), default=0.0)
        summary = {
            "cycle": self.cycle_count,
            "candidates": len(candidates),
            "survivors": len(survivors),
            "archived": archived,
            "library_size": len(self.harmonic_library),
            "best_fitness": best,
            "omega_factors": {"K": self.K, "L": self.L, "D": self.D,
                              "G": self.G, "M": self.M, "E": self.E},
            "omega_integral": self.omega_integral,
            "avg_omega": self.omega_integral / self.cycle_count,
        }
        if self.verbose:
            print(f"AGE cycle {self.cycle_count}: best={best:.3f} "
                  f"archived={archived} lib={len(self.harmonic_library)} "
                  f"avgΩ={summary['avg_omega']:.4f}")
        return summary

    def run(self, cycles: Optional[int] = None) -> List[dict]:
        return [self.run_genesis_cycle()
                for _ in range(cycles or self.conf.max_cycles)]

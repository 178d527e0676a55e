"""KAIROSAGE on PyTorch: expression genomes, their batched diffusion
fitness on the card, the genesis engine and the island model (counterpart
of ``maus_tpu/age``)."""
from . import diffusion, engine, interp, islands, tape
from .engine import AgeConfig, GenesisEngine, Genome
from .islands import IslandAGE

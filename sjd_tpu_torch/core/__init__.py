"""The SJD decode core: engine, sampling, grammar, processors, drafts and
acceptance (sjd_tpu/core)."""

from .decomposer import DecomposeResult, sequential_decompose
from .engine import EngineConfig, GenerateResult, ModelFns, SJDEngine
from .grammar import GrammarSpec, GrammarState
from .processors import SamplingParams

__all__ = ["DecomposeResult", "sequential_decompose", "EngineConfig", "GenerateResult", "ModelFns", "SJDEngine",
           "GrammarSpec", "GrammarState", "SamplingParams"]

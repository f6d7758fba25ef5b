"""The SJD decode core: engine, sampling, grammar, processors, drafts and
acceptance (sjd_tpu/core)."""

from .engine import EngineConfig, GenerateResult, ModelFns, SJDEngine
from .grammar import GrammarSpec, GrammarState
from .processors import SamplingParams

__all__ = ["EngineConfig", "GenerateResult", "ModelFns", "SJDEngine",
           "GrammarSpec", "GrammarState", "SamplingParams"]

from llm_inference_engine.evals.ppl import (
    Scorer,
    perplexity,
    quant_ppl_report,
)

__all__ = ["Scorer", "perplexity", "quant_ppl_report"]

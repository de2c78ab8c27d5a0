"""Teacher-forced perplexity evaluation (WikiText-2 style).

The quality gate for the quantization the reference engine planned but
never built (reference: README.md:36-39 lists INT8/INT4 quantization as
future work; src/weights/includes/base_weights.h:10 declares an unused
``INT8_W``): BASELINE.md requires WikiText-2 PPL within +0.1 of FP16 for
INT8 weight-only and +0.5 for INT4.

Method: the token stream is scored in fixed windows of ``window`` tokens
with the last token of each window re-used as the first (context) token of
the next, so every corpus token except the very first is predicted exactly
once (stride == window-1, the standard non-overlapping convention). All
cross-entropy math runs on device inside one jitted scorer — the host only
ever sees two scalars per batch of windows (sum NLL, token count), never a
[B, T, V] logits tensor.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from llm_inference_engine.config import EngineConfig, ModelConfig
from llm_inference_engine.models import llama as llama_model
from llm_inference_engine.ops import kv_cache as kvc

__all__ = ["Scorer", "perplexity", "quant_ppl_report", "load_text_tokens"]


class Scorer:
    """Jitted windowed log-likelihood scorer for one (config, params) pair."""

    def __init__(self, config: ModelConfig, params,
                 engine_config: Optional[EngineConfig] = None,
                 window: int = 512, batch: int = 4):
        self.config = config
        self.window = window
        self.batch = batch
        eng = engine_config or EngineConfig()
        # scoring is one prefill per window: cache sized to the window
        self.eng = eng.replace(max_batch_size=batch, max_seq_len=window)
        self.params = params
        cfg = config
        seng = self.eng

        @functools.partial(jax.jit, donate_argnums=(1,))
        def _score(params, cache, tokens, n_valid):
            """tokens [B, W] int32, n_valid [B] -> (sum_nll f32, n_pred i32).

            Scores tokens[:, 1:W] given their prefixes; row b contributes
            n_valid[b]-1 predictions (rows with n_valid<=1 contribute 0).
            """
            B, W = tokens.shape
            q_start = jnp.zeros((B,), jnp.int32)
            hidden, cache = llama_model.decoder_forward(
                cfg, seng, params, tokens, cache, q_start,
                n_valid.astype(jnp.int32))
            logits = llama_model.lm_head_logits(cfg, seng, params, hidden)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            tgt = tokens[:, 1:]                                     # [B, W-1]
            lp = jnp.take_along_axis(logp[:, :-1], tgt[..., None],
                                     axis=-1)[..., 0]               # [B, W-1]
            mask = (jnp.arange(W - 1)[None, :]
                    < (n_valid[:, None] - 1))                       # [B, W-1]
            sum_nll = -jnp.sum(jnp.where(mask, lp, 0.0))
            return sum_nll, jnp.sum(mask.astype(jnp.int32)), cache

        self._score = _score
        self._cache = kvc.new_kv_cache(
            cfg.num_layers, batch, cfg.num_kv_heads, window, cfg.head_dim,
            dtype=cfg.dtype,
            quantized=self.eng.kv_cache_dtype == jnp.int8,
            pad_to_tiles=None)  # auto: model layer adapts

    def score(self, token_ids: Sequence[int]) -> tuple[float, int]:
        """(total negative log-likelihood, number of predicted tokens)."""
        toks = np.asarray(token_ids, np.int32)
        W, B = self.window, self.batch
        stride = W - 1
        n_windows = max(1, -(-(len(toks) - 1) // stride))
        total_nll, total_n = 0.0, 0
        for wb in range(0, n_windows, B):
            rows = np.zeros((B, W), np.int32)
            n_valid = np.zeros((B,), np.int32)
            for i in range(B):
                w = wb + i
                if w >= n_windows:
                    break
                s = w * stride
                chunk = toks[s:s + W]
                rows[i, :len(chunk)] = chunk
                n_valid[i] = len(chunk)
            nll, n, self._cache = self._score(
                self.params, self._cache, jnp.asarray(rows),
                jnp.asarray(n_valid))
            total_nll += float(nll)
            total_n += int(n)
        return total_nll, total_n


def perplexity(config: ModelConfig, params, token_ids: Sequence[int],
               engine_config: Optional[EngineConfig] = None,
               window: int = 512, batch: int = 4) -> float:
    """exp(mean NLL) over the token stream."""
    nll, n = Scorer(config, params, engine_config, window, batch).score(
        token_ids)
    return math.exp(nll / max(n, 1))


def quant_ppl_report(config: ModelConfig, params_fp, token_ids,
                     modes: Sequence[str] = ("int8", "int4"),
                     group_size: int = 128, window: int = 512,
                     batch: int = 4,
                     engine_config: Optional[EngineConfig] = None) -> dict:
    """PPL of the full-precision params and each quantized variant, with
    deltas — the BASELINE.md acceptance table (<=0.1 INT8, <=0.5 INT4)."""
    from llm_inference_engine.models.weights import quantize_params
    report = {}
    base = perplexity(config, params_fp, token_ids, engine_config, window,
                      batch)
    report["fp"] = base
    for mode in modes:
        qp = quantize_params(params_fp, mode, group_size)
        p = perplexity(config, qp, token_ids, engine_config, window, batch)
        report[mode] = p
        report[f"{mode}_delta"] = p - base
    return report


def load_text_tokens(data_path: str, tokenizer) -> list[int]:
    """Tokenize a raw text file (e.g. WikiText-2 test split) into one
    stream. ``.npy``/``.npz`` files of pre-tokenized ids are accepted
    directly (key 'tokens' for npz)."""
    if data_path.endswith(".npy"):
        return np.load(data_path).astype(np.int64).tolist()
    if data_path.endswith(".npz"):
        return np.load(data_path)["tokens"].astype(np.int64).tolist()
    with open(data_path, encoding="utf-8") as f:
        text = f.read()
    return tokenizer.encode(text, add_bos=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="Windowed perplexity eval (WikiText-2 style)")
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--checkpoint", help="HF safetensors dir")
    ap.add_argument("--tokenizer", help="tokenizer file/dir "
                    "(default: checkpoint dir)")
    ap.add_argument("--data", required=True,
                    help="text file, .npy/.npz token ids")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int4", "compare"])
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dummy-weights", action="store_true")
    args = ap.parse_args(argv)

    from llm_inference_engine.config import get_config
    from llm_inference_engine.models.weights import (
        init_dummy_params, load_hf_safetensors, quantize_params)

    cfg = get_config(args.model)
    if args.dummy_weights:
        params = init_dummy_params(cfg, seed=0)
    else:
        params = load_hf_safetensors(cfg, args.checkpoint)

    if args.data.endswith((".npy", ".npz")):
        tokens = load_text_tokens(args.data, None)
    else:
        from llm_inference_engine.tokenizer import load_tokenizer
        tok = load_tokenizer(args.tokenizer or args.checkpoint)
        tokens = load_text_tokens(args.data, tok)

    if args.quant == "compare":
        rep = quant_ppl_report(cfg, params, tokens,
                               group_size=args.group_size,
                               window=args.window, batch=args.batch)
        print(json.dumps({"model": args.model, "n_tokens": len(tokens),
                          **rep}))
        return
    if args.quant != "none":
        params = quantize_params(params, args.quant, args.group_size)
    ppl = perplexity(cfg, params, tokens, window=args.window,
                     batch=args.batch)
    print(json.dumps({"model": args.model, "quant": args.quant,
                      "n_tokens": len(tokens), "ppl": ppl}))


if __name__ == "__main__":
    main()

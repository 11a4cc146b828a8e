"""Test-sized overrides of each cell: the same files, drivers and
comparison at toy widths, so a CPU run drives the whole harness."""

GPT = {"n_embd": 64, "n_layer": 2, "n_head": 4, "n_positions": 128,
       "n_ctx": 128, "vocab_size": 256}
BERT = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 128, "max_position_embeddings": 128,
        "vocab_size": 1024}

OVERRIDES = {
    "gpt2s-train-t1024": {
        "config": GPT,
        "traffic": {"batch": 2, "seq": 64, "n_batches": 4, "eos_id": 255,
                    "doc_len": {"dist": "lognormal", "median": 20,
                                "sigma": 1.0, "lo": 4, "hi": 200}}},
    "bertb-mlm-t128": {
        "config": BERT,
        "traffic": {"batch": 4, "seq": 64, "n_batches": 4, "short_min": 16,
                    "word_lo": 200, "short_seq_prob": 0.25}},
    "gpt2s-serve-batch": {
        "config": GPT,
        "traffic": {"clients": 6, "n_slots": 2, "pool": 64, "ramp_s": 0.2,
                    "prompt": {"dist": "exponential", "mean": 16, "lo": 4,
                               "hi": 96},
                    "output": {"dist": "exponential", "mean": 10, "lo": 4},
                    "max_total": 128},
        "workload": {"check_requests": 8}},
}


def overrides(cell: str, **extra):
    o = {k: dict(v) for k, v in OVERRIDES[cell].items()}
    for k, v in extra.items():
        o.setdefault(k, {}).update(v)
    return o

"""Small sizes that the CPU tests run the harness at (never timed)."""

MOE = dict(n_layers=2, d_model=512, n_heads=4, n_kv_heads=4, head_dim=16,
           d_ff=32, vocab=256, n_experts=4, topk=2)
PREFILL = dict(clients=2, pool=4, sample_tokens=8,
               prompt={"lognormal": [24, 0.6], "levels": 4, "min": 16,
                       "max": 64, "multiple": 8})
DECODE = dict(clients=4, pool=2, prompt={"lognormal": [16, 0.6], "levels": 2,
                                         "min": 8, "max": 32, "multiple": 8},
              output={"lognormal": [6, 0.5], "levels": 4, "min": 2,
                      "max": 12})
SIZES = {"olmoe-1b-7b-serve-prefill": (MOE, PREFILL),
         "olmoe-1b-7b-serve-decode": (MOE, DECODE)}

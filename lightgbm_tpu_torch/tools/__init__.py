"""Scripts of the port, each run as ``python3 -m
lightgbm_tpu_torch.tools.<name>``: measurements on a CUDA card
(hist_tiling, h2d_copies) and the operations scripts (ingest_smoke,
serve_smoke, gateway_rolling, chaos, obs_report), on the card unless
``--device cpu`` is given."""

"""Command-line drivers of the port (``ecm_tpu.cli``): train, finetune,
evaluate, submission and test_img, with the same flags and presets."""

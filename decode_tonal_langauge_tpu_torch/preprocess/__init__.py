"""Preprocess stage: config-driven signal pipelines over raw recordings.

Counterpart of ``decode_tonal_langauge_tpu/preprocess/``, with the same
plugin contracts: a stage entry (``main.run(config) -> setup_dir``), a
pipeline module (``run(pipeline_params, io_params, io_module,
preprocessor_module, modalities_cfg)``), an IO backend
(``load_block``/``save_block``) and signal steps (``run(data, params)``
on a (C, T) tensor, returning a tensor on the same device and updating
``params.signal_freq`` where the rate changes).
"""

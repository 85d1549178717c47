"""Export, serving runtimes and int8 quantization (port of ``focoos_tpu/infer``)."""

"""Engine layer: continuous batching, execution, sampling, detokenization
(the PyTorch counterpart of ``atoma_infer_tpu/engine``)."""

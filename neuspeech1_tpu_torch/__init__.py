"""PyTorch and CUDA port of neuspeech1_tpu (brain signal -> text with a
Whisper-style encoder-decoder) for one NVIDIA Hopper GPU.

Serving: ``serve.Transcriber`` -> ``decode.generate`` (greedy, beam search,
or self-speculative greedy in ``decode.spec``) -> ``models.whisper``
(encoder through the flash-attention kernel in ``csrc/flash_fwd_btc.cu``;
cached decoder through the decode kernels in ``csrc/decode_cross.cu``,
``csrc/decode_step.cu`` and ``csrc/decode_step_multi.cu``). Training:
``train.trainstep`` (LoRA step through the flash backward and LoRA adapter
backward kernels). Evaluation: ``cli.evaluation`` (manifest ->
``data.dataset``/``collate``/``loader`` -> ``decode.generate`` with the
sequence bias of ``decode.sequence_bias`` -> ``metrics.battery`` -> result
files); ``cli.evaluation_speech`` does the same on the manifests' wavs
(``data.dataset.SpeechDataset``, the log-mel of ``ops.audio``). Data
preparation on the host: ``cli.prepare_data`` (``data.preprocess``) and
``cli.manifest_tools``. The package imports ``torch`` and never ``jax``, and nothing of
the JAX package ``neuspeech1_tpu``: it keeps its own copies of the modules
it needs (``config``, ``utils.{tokenizer,args,text,zh_t2s}``,
``models.convert.load_npz``, ``models.quantize.quantize_int8``, ``data``,
``metrics``, ``decode.{yake,sequence_bias}``).
"""

__version__ = "0.1.0"

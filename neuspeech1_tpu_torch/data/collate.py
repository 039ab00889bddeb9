"""Batch collation: stack features, pad labels, build shifted decoder inputs.
The port's copy of ``neuspeech1_tpu/data/collate.py``; batches are numpy.

Parity with reference `utils/data_utils.py:182-221`
(`DataCollatorSpeechSeq2SeqWithPadding`): labels are padded and masked to
-100, and the leading `<|startoftranscript|>` is stripped (HF's forward then
re-creates it via shift_tokens_right; here the collator emits the shifted
`decoder_input_ids` explicitly so the train step gets ready tensors).

Label length is padded to a fixed bucket (multiple of ``pad_to_multiple``,
or the static ``max_label_len``), as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from neuspeech1_tpu_torch.config import LABEL_IGNORE_ID


class Collator:
    def __init__(
        self,
        pad_id: int,
        decoder_start_id: int,
        max_label_len: Optional[int] = None,
        pad_to_multiple: int = 8,
        strip_sot: bool = True,
        eot_id: Optional[int] = None,
    ):
        self.pad_id = pad_id
        self.decoder_start_id = decoder_start_id
        self.max_label_len = max_label_len
        self.pad_to_multiple = pad_to_multiple
        self.strip_sot = strip_sot
        self.eot_id = eot_id
        self.n_truncated = 0  # visible counter: silent truncation skews WER
        self._warned_truncation = False

    def _target_len(self, lens: Sequence[int]) -> int:
        if self.max_label_len is not None:
            return self.max_label_len
        m = max(lens)
        p = self.pad_to_multiple
        return -(-m // p) * p

    def __call__(self, samples: List[dict]) -> dict:
        feats = np.stack([s["input_features"] for s in samples]).astype(
            np.float32
        )
        label_lists = []
        for s in samples:
            lab = list(s["labels"])
            if self.strip_sot and lab and lab[0] == self.decoder_start_id:
                lab = lab[1:]
            label_lists.append(lab)
        tlen = self._target_len([len(l) for l in label_lists])
        b = len(samples)
        labels = np.full((b, tlen), LABEL_IGNORE_ID, dtype=np.int32)
        for i, lab in enumerate(label_lists):
            if len(lab) > tlen:
                # keep the trailing <|endoftext|> so truncated samples still
                # carry EOS supervision (byte-tokenized 30 s sentences exceed
                # default buckets easily)
                eot = self.eot_id if self.eot_id is not None else lab[-1]
                lab = lab[: tlen - 1] + [eot]
                self.n_truncated += 1
                if not self._warned_truncation:
                    self._warned_truncation = True
                    import warnings

                    warnings.warn(
                        f"label longer than max_label_len={tlen} truncated "
                        "(EOS kept); count in Collator.n_truncated"
                    )
            labels[i, : len(lab)] = lab
        # decoder input = [start] + labels[:-1], with ignore -> pad
        dec_in = np.full((b, tlen), self.pad_id, dtype=np.int32)
        dec_in[:, 0] = self.decoder_start_id
        src = labels[:, :-1]
        dec_in[:, 1:] = np.where(src == LABEL_IGNORE_ID, self.pad_id, src)
        return {
            "input_features": feats,
            "labels": labels,
            "decoder_input_ids": dec_in,
        }

"""Featurization CLI of the port (preprocess.py:7-19).

    python -m ctts_torch.preprocess --dataset LJSpeech [--config_dir DIR] \\
        [--device cpu]

Reads ``preprocess.path.raw_path`` (one directory a speaker of ``.wav`` and
``.lab`` files, as ``python -m ctts_torch.prepare_align`` writes them) and
the TextGrids under ``preprocessed_path/TextGrid``, and writes the ``.npy``
store to ``preprocessed_path``
(:class:`ctts_torch.preprocessing.preprocessor.Preprocessor`). The mel,
energy, f0 and speaker embeddings run on ``cuda`` unless ``--device``
names another device. ``CTTS_PREPROCESS_WORKERS=N`` spreads the utterances
over N spawned workers on the same device; the files are the same bytes for
any N.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    from ctts_torch.config import get_configs_of
    from ctts_torch.preprocessing.preprocessor import Preprocessor
    preprocess_config, model_config, train_config = get_configs_of(
        args.dataset, args.config_dir)
    Preprocessor(preprocess_config, model_config, train_config,
                 device=args.device).build_from_path()


if __name__ == "__main__":
    main()

"""CPC self-supervised pretraining (JAX ``cli/train_cpc.py``).

    python -m freesound_classification_tpu_torch.cli.train_cpc \\
        --train_df train.csv --train_data_dir train --classmap classmap.json \\
        --features mel_2048_1024_128 --optimizer adam --folds 0 \\
        [--device cuda] [--p_aug 0.75] [--n_encoder_layers 5] ...

See ``cli/ssl_common.py``.
"""

from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.cli.ssl_common import main_cpc as main

if __name__ == "__main__":
    common.log_launches_at_exit()
    main()

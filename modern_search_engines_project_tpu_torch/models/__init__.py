from modern_search_engines_project_tpu_torch.models.checkpoint import (
    latest_step_dir,
    load_encoder,
    read_checkpoint,
    save_encoder,
    write_checkpoint,
)
from modern_search_engines_project_tpu_torch.models.cross_encoder import (
    CrossEncoder,
    CrossEncoderReranker,
    cross_encoder_params_from_reference,
    cross_encoder_params_to_reference,
    init_cross_encoder_params,
    train_cross_encoder,
)
from modern_search_engines_project_tpu_torch.models.decoder import (
    DecoderConfig,
    DecoderLM,
    GreedyGenerator,
    decoder_params_from_reference,
    init_decoder_params,
    load_decoder,
    save_decoder,
)
from modern_search_engines_project_tpu_torch.models.encoder import (
    BiEncoder,
    EncoderConfig,
    TorchEncoder,
    init_reference_params,
    params_digest,
    params_from_reference,
    params_to_reference,
)
from modern_search_engines_project_tpu_torch.models.hash_encoder import HashingEncoder
from modern_search_engines_project_tpu_torch.models.train import (
    TrainConfig,
    Trainer,
    cosine_loss,
    mine_hard_negatives,
    mine_hn_triples,
)
from modern_search_engines_project_tpu_torch.models.word_vocab import WordVocab

__all__ = [
    "BiEncoder",
    "TrainConfig",
    "Trainer",
    "CrossEncoder",
    "CrossEncoderReranker",
    "DecoderConfig",
    "DecoderLM",
    "EncoderConfig",
    "GreedyGenerator",
    "HashingEncoder",
    "TorchEncoder",
    "WordVocab",
    "cosine_loss",
    "cross_encoder_params_from_reference",
    "cross_encoder_params_to_reference",
    "decoder_params_from_reference",
    "init_cross_encoder_params",
    "init_decoder_params",
    "init_reference_params",
    "latest_step_dir",
    "load_decoder",
    "load_encoder",
    "mine_hard_negatives",
    "mine_hn_triples",
    "params_digest",
    "params_from_reference",
    "params_to_reference",
    "read_checkpoint",
    "save_decoder",
    "save_encoder",
    "train_cross_encoder",
    "write_checkpoint",
]

"""Config-driven sliding-window prediction (the JAX package's
``cli/predict3d.py``).

    python -m mdeical_image_segmentation_tpu_torch.cli.predict3d \\
        --config configs/unet3d_predict.yml \\
        --loaders.test.file_paths "['/data/test']" [--device cpu]

Config keys: ``model_path`` (a training checkpoint of either package; top
level, or ``model.model_path``), ``model``, ``loaders.test`` (files, the
slice builder with patch == stride and a halo, the transformer),
``predictor`` and ``output_dir``.  The model runs on the card unless
``device: cpu``.  ``loaders.dataset`` and ``predictor.name`` pick the
dataset and the predictor: ``StandardHDF5Dataset`` / ``StandardPredictor``
(the default), ``LazyHDF5Dataset`` / ``LazyPredictor`` for volumes larger
than RAM, ``DSB2018Dataset`` / ``DSB2018Predictor`` for a directory of 2D
PNG images (``file_paths: [<root with images/>]``).  Each test file (each
image, for DSB2018) gets ``<name>_predictions.h5`` with the dataset
``predictions`` (DSB2018 adds ``segmentation``; LazyPredictor with
``save_segmentation`` keeps ``segmentation`` alone).
"""

import sys


def main(argv=None):
    from ..configs import load_config
    from ..data.loaders import get_test_loaders
    from ..infer import predictor as predictor_lib
    from ..models import get_model
    from ..train.checkpoint import load_checkpoint
    from ..train.trainer3d import config_device
    from ..utils.param_bridge import flax_to_state_dict

    config = load_config(argv if argv is not None else sys.argv[1:])
    model_path = config.get("model_path") or config["model"].get("model_path")
    if not model_path:
        raise KeyError("prediction config needs a top-level 'model_path' (or "
                       "'model.model_path') pointing at a training "
                       "checkpoint")
    device = config_device(config)
    model = get_model(config["model"], device=device)
    model.load_state_dict(flax_to_state_dict(
        load_checkpoint(model_path)["model_state_dict"]))
    model.eval()
    predictor = predictor_lib.get_predictor(model, config.get("output_dir"),
                                            config)
    return [predictor(loader) for loader in get_test_loaders(config)]


if __name__ == "__main__":
    main()

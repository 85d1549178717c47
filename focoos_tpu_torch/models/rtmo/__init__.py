"""rtmo family registration (port of focoos_tpu/models/rtmo/__init__.py)."""

from focoos_tpu_torch.ports import ModelFamily


def _register():
    from focoos_tpu_torch.model_manager import BackboneManager, ConfigManager, ModelManager
    from focoos_tpu_torch.models.rtmo.config import RTMOConfig
    from focoos_tpu_torch.processor.processor_manager import ProcessorManager

    ConfigManager.register(ModelFamily.RTMO, RTMOConfig)

    def build(config: RTMOConfig):
        from focoos_tpu_torch.models.rtmo.modelling import RTMO

        return RTMO(config=config, backbone=BackboneManager.from_config(config.backbone_config))

    ModelManager.register_model(ModelFamily.RTMO, build)

    def processor_loader(config, image_size=None):
        from focoos_tpu_torch.models.rtmo.processor import RTMOProcessor

        return RTMOProcessor(config, image_size)

    ProcessorManager.register(ModelFamily.RTMO, processor_loader)

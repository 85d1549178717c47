"""fai_detr family registration (port of focoos_tpu/models/fai_detr/__init__.py)."""

from focoos_tpu.ports import ModelFamily


def _register():
    from focoos_tpu_torch.model_manager import BackboneManager, ConfigManager, ModelManager
    from focoos_tpu_torch.models.fai_detr.config import DETRConfig
    from focoos_tpu_torch.processor.processor_manager import ProcessorManager

    ConfigManager.register(ModelFamily.DETR, DETRConfig)

    def build(config: DETRConfig):
        from focoos_tpu_torch.models.fai_detr.modelling import FAIDetr

        return FAIDetr(config=config, backbone=BackboneManager.from_config(config.backbone_config))

    ModelManager.register_model(ModelFamily.DETR, build)

    def processor_loader(config, image_size=None):
        from focoos_tpu_torch.models.fai_detr.processor import DETRProcessor

        return DETRProcessor(config, image_size)

    ProcessorManager.register(ModelFamily.DETR, processor_loader)

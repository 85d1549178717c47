"""fai_cls family registration (port of focoos_tpu/models/fai_cls/__init__.py)."""

from focoos_tpu_torch.ports import ModelFamily


def _register():
    from focoos_tpu_torch.model_manager import BackboneManager, ConfigManager, ModelManager
    from focoos_tpu_torch.models.fai_cls.config import ClassificationConfig
    from focoos_tpu_torch.processor.processor_manager import ProcessorManager

    ConfigManager.register(ModelFamily.IMAGE_CLASSIFIER, ClassificationConfig)

    def build(config: ClassificationConfig):
        from focoos_tpu_torch.models.fai_cls.modelling import FAIClassification

        return FAIClassification(config=config, backbone=BackboneManager.from_config(config.backbone_config))

    ModelManager.register_model(ModelFamily.IMAGE_CLASSIFIER, build)

    def processor_loader(config, image_size=None):
        from focoos_tpu_torch.models.fai_cls.processor import ClassificationProcessor

        return ClassificationProcessor(config, image_size)

    ProcessorManager.register(ModelFamily.IMAGE_CLASSIFIER, processor_loader)

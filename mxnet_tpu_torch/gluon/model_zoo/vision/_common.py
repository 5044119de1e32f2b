"""Shared zoo-factory helper (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/_common.py``)."""


def load_pretrained(net, name, pretrained):
    """Load cached pretrained weights into ``net`` when requested.

    As each reference factory does (gluon/model_zoo/vision/resnet.py):
    ``model_store.get_model_file`` then ``load_params``. The file is read
    from the local cache, never downloaded.
    """
    if not pretrained:
        return net
    from ..model_store import get_model_file
    net.load_params(get_model_file(name))
    return net

from hetu_tpu_torch.models.bert import (BertConfig, BertForMaskedLM,
                                        BertForNextSentencePrediction,
                                        BertForPreTraining,
                                        BertForSequenceClassification,
                                        BertModel, BertMoEForPreTraining,
                                        BertMoEModel, bert_base, bert_large)
from hetu_tpu_torch.models.ctr import (DCN, CTRConfig, DeepCrossing, DeepFM,
                                       WideDeep, make_embedding)
from hetu_tpu_torch.models.gnn import (GCN, DistGCN15D, GraphConv,
                                       GraphIndex, dist_spmm_15d,
                                       normalize_adjacency, sample_subgraph,
                                       spmm_edges)
from hetu_tpu_torch.models.gpt import (GPT, GPTConfig, gpt2_large,
                                       gpt2_medium, gpt2_small)
from hetu_tpu_torch.models.moe_lm import MoEBlock, MoELM, MoELMConfig
from hetu_tpu_torch.models.ncf import GMF, MF, MLPRec, NeuMF
from hetu_tpu_torch.models.resnet import BasicBlock, ResNet, resnet18, resnet34
from hetu_tpu_torch.models.rnn import (RNN, GRUCell, LSTMCell, RNNCell,
                                       RNNClassifier)
from hetu_tpu_torch.models.simple import MLP, LeNet, LogReg, alexnet, vgg16
from hetu_tpu_torch.models.swin import (Swin, SwinConfig, swin_base,
                                        swin_large, swin_tiny)
from hetu_tpu_torch.models.t5 import (T5Config, T5ForConditionalGeneration,
                                      T5Model, t5_base, t5_large, t5_small)
from hetu_tpu_torch.models.vit import (ViT, ViTConfig, vit_base, vit_huge,
                                       vit_large)

__all__ = ["GPT", "GPTConfig", "gpt2_small", "gpt2_medium", "gpt2_large",
           "BertConfig", "BertModel", "BertForPreTraining", "bert_base",
           "bert_large", "BertForMaskedLM", "BertForNextSentencePrediction",
           "BertForSequenceClassification", "BertMoEModel",
           "BertMoEForPreTraining", "MoELMConfig", "MoEBlock", "MoELM",
           "CTRConfig", "WideDeep", "DeepFM", "DCN",
           "DeepCrossing", "make_embedding", "MF", "GMF", "MLPRec",
           "NeuMF", "BasicBlock", "ResNet", "resnet18", "resnet34", "MLP",
           "LeNet", "LogReg", "alexnet", "vgg16", "ViT", "ViTConfig",
           "vit_base", "vit_large", "vit_huge", "Swin", "SwinConfig",
           "swin_tiny", "swin_base", "swin_large", "T5Config", "T5Model",
           "T5ForConditionalGeneration", "t5_small", "t5_base", "t5_large",
           "RNNCell", "LSTMCell", "GRUCell", "RNN", "RNNClassifier",
           "normalize_adjacency", "spmm_edges", "GraphConv", "GCN",
           "dist_spmm_15d", "DistGCN15D", "GraphIndex", "sample_subgraph"]

from .acs import ACSAutomata
from .benchmark import BenchmarkEvaluator
from .injector import LLMInjector
from .kg_builder import KGBuilder
from .network_info import NetworkInfoProvider
from .pre_injector import PreLLMInjector
from .refiner import GlobalRefiner
from .retriever import OfflineRetriever, OnlineRetriever
from .retriever_hybrid import HybridRetriever

__all__ = ["ACSAutomata", "BenchmarkEvaluator", "LLMInjector", "KGBuilder",
           "NetworkInfoProvider", "PreLLMInjector", "GlobalRefiner",
           "OfflineRetriever", "OnlineRetriever", "HybridRetriever"]

from .embed_client import (EmbedClient, HttpEmbedClient, TPUEmbedClient,
                           make_embed_client)
from .llm_client import (ChatClient, HttpChatClient, LocalChatClient,
                         make_chat_client)
from .rerank_client import (HttpRerankClient, RerankClient, RerankerError,
                            TPURerankClient, make_rerank_client)

__all__ = [
    "EmbedClient", "HttpEmbedClient", "TPUEmbedClient", "make_embed_client",
    "ChatClient", "HttpChatClient", "LocalChatClient", "make_chat_client",
    "HttpRerankClient", "RerankClient", "RerankerError", "TPURerankClient",
    "make_rerank_client",
]

"""The OpenAI HTTP frontend and the model pipelines behind it."""

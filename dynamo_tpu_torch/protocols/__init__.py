"""Wire protocols (OpenAI chat and completions)."""

"""Text front end: the WordPiece tokenizer."""

"""Host-side data: the preprocessed-corpus dataset and its grouped loader."""

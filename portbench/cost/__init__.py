"""Operations and bytes from shapes alone, whatever the implementation
does: each input byte read once, each output byte written once."""
